"""Write tests/data/torch_port_serve_golden.npz from the JAX package.

For every arch of the port at SMOKE width (float32): the weights, fixed
prompts (numpy seed), the prefill logits, every greedy decode step's logits
and the greedy tokens, from the reference's ``make_prefill`` /
``make_serve_step`` with a cache of prompt + gen + 8 slots. starcoder2-3b
and mamba2-130m keep the reference's own weights (``lm.init`` with
``jax.random.PRNGKey(SEED)``; the training golden starts from them); the
other archs' weights are drawn from a numpy seed
(``repro_torch.convert.seeded_reference_params``) and the golden holds
the seed and the leaves' shapes, not the weights. whisper-medium's
encoder frames (BATCH, PROMPT_LEN, d_model) and phi-3-vision-4.2b's image
patches (BATCH, n_patches, d_vision) are drawn after the prompts from the
same generator and stored; the VLM's cache holds its patches too. The port's
``chip_smoke.py`` loads the weights into the port on the card and holds
its logits and tokens against these (the card's machine has no JAX). JAX
runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_serve_golden.py

Keys, per arch ``<a>``: ``<a>/param/<path>`` (the reference's pytree,
``blocks.<i>.`` for pattern position i, stacked over groups), or
``<a>/param_seed`` and ``<a>/param_shapes`` (JSON: {path: shape}),
``<a>/prompts``, ``<a>/frames`` or ``<a>/images`` (float32),
``<a>/prefill_logits`` (b, 1, vocab),
``<a>/step_logits`` (gen - 1, b, 1, vocab), ``<a>/tokens`` (b, gen) and
``<a>/min_top2_gap``, the smallest gap between the two largest logits of
any greedy pick (a pick closer than the comparison's tolerance would be a
tie, not a check).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch
from repro.launch import steps
from repro_torch.convert import seeded_reference_params

SEED = 12
ARCHS = ("starcoder2-3b", "mamba2-130m", "granite-20b", "qwen1.5-110b", "gemma3-12b",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "zamba2-7b", "phi-3-vision-4.2b",
         "whisper-medium")
BATCH, PROMPT_LEN, GEN = 2, 40, 8
# the archs whose golden holds the reference's own weights
STORED = ("starcoder2-3b", "mamba2-130m")
OUT = os.path.join(os.path.dirname(__file__), "..", "data", "torch_port_serve_golden.npz")


def _flatten(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten(t, f"{prefix}.{i}")
    else:
        yield prefix, np.asarray(tree)


def _top2_gap(logits: np.ndarray) -> float:
    top = np.sort(logits[:, -1], axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def golden(arch_id: str) -> dict:
    arch = get_arch(arch_id)
    cfg = arch.smoke
    params = arch.init(jax.random.PRNGKey(SEED), cfg)
    if arch_id not in STORED:
        shapes = {k: list(v.shape) for k, v in _flatten(params, "")}
        params = jax.tree_util.tree_map(jnp.asarray, seeded_reference_params(shapes, SEED))
    rng = np.random.default_rng(SEED)
    prompts = np.concatenate([rng.integers(0, cfg.vocab, (1, PROMPT_LEN)).astype(np.int32)
                              for _ in range(BATCH)], 0)
    extra, max_len = {}, PROMPT_LEN + GEN + 8
    if arch.is_encdec():
        extra["frames"] = rng.normal(0, 1, (BATCH, PROMPT_LEN, cfg.d_model)).astype(np.float32)
    if getattr(cfg, "vision", None) is not None:
        extra["images"] = rng.normal(
            0, 1, (BATCH, cfg.vision.n_patches, cfg.vision.d_vision)).astype(np.float32)
        max_len += cfg.vision.n_patches
    prefill = jax.jit(steps.make_prefill(arch, cfg, max_cache_len=max_len))
    serve_step = jax.jit(steps.make_serve_step(arch, cfg))
    batch = {"tokens": jnp.asarray(prompts), **{k: jnp.asarray(v) for k, v in extra.items()}}
    caches, logits = prefill(params, batch)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    prefill_logits, gaps = np.asarray(logits), [_top2_gap(np.asarray(logits))]
    tokens, step_logits = [np.asarray(tok)], []
    for _ in range(GEN - 1):
        caches, tok, logits = serve_step(params, caches, tok)
        tokens.append(np.asarray(tok))
        step_logits.append(np.asarray(logits))
        gaps.append(_top2_gap(np.asarray(logits)))
    if arch_id in STORED:
        out = {f"{arch_id}/param/{k}": v for k, v in _flatten(params, "")}
    else:
        out = {f"{arch_id}/param_seed": np.int64(SEED),
               f"{arch_id}/param_shapes": np.array(json.dumps(shapes, sort_keys=True))}
    out.update({
        f"{arch_id}/prompts": prompts,
        **{f"{arch_id}/{k}": v for k, v in extra.items()},
        f"{arch_id}/prefill_logits": prefill_logits,
        f"{arch_id}/step_logits": np.stack(step_logits),
        f"{arch_id}/tokens": np.concatenate(tokens, 1),
        f"{arch_id}/min_top2_gap": np.float32(min(gaps)),
    })
    return out


def main() -> int:
    payload = {}
    for arch_id in ARCHS:
        payload.update(golden(arch_id))
        print(f"{arch_id}: min top-2 logit gap {float(payload[f'{arch_id}/min_top2_gap']):.3g}")
    np.savez_compressed(OUT, **payload)
    print(f"wrote {len(payload)} arrays, {os.path.getsize(OUT)} bytes, to "
          f"{os.path.normpath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
