"""Write tests/data/torch_port_train_golden.npz from the JAX package.

For starcoder2-3b and mamba2-130m at SMOKE width (float32), from the
reference's weights in tests/data/torch_port_serve_golden.npz (read, not
changed) and the reference's ``SyntheticPipeline`` batches:

* ``<a>/train/{loss,ce,grad_norm,lr}`` (STEPS,) and ``<a>/train/param/<path>``
  (the parameters after the last step): STEPS steps of the reference's
  ``launch/steps.make_train_step``;
* ``<a>/compressed/{loss,grad_norm,lr}`` and ``<a>/compressed/param/<path>``:
  STEPS steps of the body of ``launch/train.make_compressed_dp_step`` at
  one rank (``compress.compressed_grad_tree`` over the axis "data" under
  ``jax.vmap``, which binds the axis name as the step's ``shard_map``
  does);
* ``meta/{batch,seq,data_seed,steps,peak_lr,warmup,total_steps}``.

Parameter paths are the reference's pytree paths (``blocks.<i>.`` for
pattern position i, stacked over groups). The port's ``chip_smoke.py``
holds its SMOKE training on the card against this file (the card's
machine has no JAX); ``tests/test_torch_train.py`` checks that the live
reference still computes it. JAX runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_train_golden.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch
from repro.data.pipeline import PipelineConfig, SyntheticPipeline
from repro.launch import steps
from repro.optim import adamw, compress

ARCHS = ("starcoder2-3b", "mamba2-130m")
BATCH, SEQ, DATA_SEED, STEPS = 4, 32, 5, 3
# warm-up ends inside the run (lr 5e-3, 1e-2, then the cosine's end 1e-3);
# the default clip norm of 1.0 is active at these weights
OPT = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=STEPS)
DATA = os.path.join(os.path.dirname(__file__), "..", "data")
SERVE_GOLDEN = os.path.join(DATA, "torch_port_serve_golden.npz")
OUT = os.path.join(DATA, "torch_port_train_golden.npz")


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from flatten(t, f"{prefix}.{i}")
    else:
        yield prefix, np.asarray(tree)


def unflatten(flat: dict) -> dict:
    """{dotted path: array} -> the reference's pytree (``blocks`` a list)."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def reference_params(arch_id: str) -> dict:
    """The reference's SMOKE weights of ``arch_id`` (numpy pytree)."""
    prefix = f"{arch_id}/param/"
    with np.load(SERVE_GOLDEN) as z:
        return unflatten({k[len(prefix):]: z[k] for k in z.files if k.startswith(prefix)})


def batches(cfg, n: int = STEPS):
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH,
                                            seed=DATA_SEED))
    return [pipe.batch_at(i) for i in range(n)]


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def train_run(arch_id: str, accum: int = 1) -> dict:
    """STEPS steps of ``make_train_step``: per-step metrics and the final
    parameters (flattened)."""
    arch = get_arch(arch_id)
    cfg = arch.smoke
    params = _as_jax(reference_params(arch_id))
    opt_state = adamw.init(params)
    step = jax.jit(steps.make_train_step(arch, cfg, OPT, accum=accum))
    hist = {k: [] for k in ("loss", "ce", "grad_norm", "lr")}
    for b in batches(cfg):
        params, opt_state, m = step(params, opt_state, _as_jax(b))
        for k in hist:
            hist[k].append(float(m[k]))
    out = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    out.update({f"param/{k}": v for k, v in flatten(params)})
    return out


def compressed_run(arch_id: str, ranks: int = 1) -> dict:
    """STEPS steps of the compressed data-parallel step over ``ranks``
    simulated ranks (``jax.vmap`` over a leading axis named "data"; rank r
    takes the r-th contiguous slice of the batch, as ``shard_map``'s
    P("data") does)."""
    arch = get_arch(arch_id)
    cfg = arch.smoke

    def local(params, opt_state, residuals, batch):
        def loss_of(p):
            return arch.loss_fn(cfg, p, batch)

        (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
        grads, residuals = compress.compressed_grad_tree(grads, residuals, "data")
        loss = jax.lax.pmean(loss, "data")
        new_p, new_o, metrics = adamw.update(OPT, params, grads, opt_state)
        return new_p, new_o, residuals, {"loss": loss, **metrics}

    step = jax.jit(jax.vmap(local, axis_name="data"))

    def stack(tree):
        return jax.tree_util.tree_map(lambda x: jnp.stack([jnp.asarray(x)] * ranks), tree)

    params = stack(reference_params(arch_id))
    opt_state = stack(adamw.init(_as_jax(reference_params(arch_id))))
    residuals = stack(compress.init_residuals(_as_jax(reference_params(arch_id))))
    hist = {k: [] for k in ("loss", "grad_norm", "lr")}
    for b in batches(cfg):
        shards = {k: jnp.asarray(v).reshape((ranks, BATCH // ranks) + v.shape[1:])
                  for k, v in b.items()}
        params, opt_state, residuals, m = step(params, opt_state, residuals, shards)
        for k in hist:
            hist[k].append(float(m[k][0]))
    out = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    out.update({f"param/{k}": v[0] for k, v in flatten(params)})
    return out


def golden() -> dict:
    payload = {
        "meta/batch": np.int64(BATCH), "meta/seq": np.int64(SEQ),
        "meta/data_seed": np.int64(DATA_SEED), "meta/steps": np.int64(STEPS),
        "meta/peak_lr": np.float64(OPT.peak_lr), "meta/warmup": np.int64(OPT.warmup_steps),
        "meta/total_steps": np.int64(OPT.total_steps),
    }
    for arch_id in ARCHS:
        for kind, run in (("train", train_run), ("compressed", compressed_run)):
            for k, v in run(arch_id).items():
                payload[f"{arch_id}/{kind}/{k}"] = v
    return payload


def main() -> int:
    payload = golden()
    np.savez_compressed(OUT, **payload)
    for arch_id in ARCHS:
        print(f"{arch_id}: losses {payload[f'{arch_id}/train/loss']}, compressed "
              f"{payload[f'{arch_id}/compressed/loss']}")
    print(f"wrote {len(payload)} arrays, {os.path.getsize(OUT)} bytes, to "
          f"{os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
