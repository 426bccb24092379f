"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step as one
rank and count its roofline terms, the reference's ``launch/dryrun.py``.

The reference lowers and compiles each cell for 512 placeholder CPU
devices and reads XLA's cost analysis and HLO text. Here a cell runs
eagerly, once, as rank 0 of a fake world of 512 ranks
(``mesh.dryrun_world``: one process, no communication), on meta tensors
(shapes and dtypes; nothing is allocated or computed):

  1. the model is built on the meta device; its parameters (and, for a
     train cell, the AdamW moments; for decode, the caches) become
     DTensors on the pod (16, 16) or multipod (2, 16, 16) mesh with the
     placements of ``parallel/sharding.py``, each holding a meta shard of
     rank 0's shape;
  2. the step (``launch/steps.py``: a train step with AdamW and the
     cell's gradient accumulation, ``TRAIN_ACCUM``; a prefill into a
     cache of seq + the VLM's patches; one serve step at the last of
     cell.seq slots, ``lm.set_cache_position``) runs under the activation
     and FSDP policies and ``hlo_analysis.RooflineCounter``, which counts
     the ops rank 0 runs at its local shapes; the outputs are then brought
     to their placements (caches to their specs; an output left a partial
     sum is reduced, as XLA must before it returns it);
  3. every group of layers runs the same ops, so a cell deeper than two
     groups is traced at one and two and its counts extrapolated to the
     full depth (``count_cell``), as the reference multiplies a scanned
     group's body by its trip count;
  4. the record (the reference's keys) goes to
     ``experiments/dryrun/<arch>__<shape>__<mesh>.json``, the directory
     ``core/engine.DRYRUN_DIR`` reads, so either package's records feed
     either package's intake.

Every kernel call passes ``impl="ref"``: the plain version, as the
reference's CPU dry run lowers its jnp path; no kernel launches
(``"kernels": "plain"``). The plain attention runs as one query block by
one key block (``ops.plain_attention_blocks``): the reference scans its
blocks, which XLA counts once a trip; stepping through them eagerly
would cost minutes a long cell. ``--device`` is the mesh's device type (the card
unless the caller asks for the host, ``repro_torch/device.py``); the
shards themselves are meta tensors either way.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--skip-existing] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import obs
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun")

# Gradient-accumulation microbatches per train cell, the reference's.
# Keys absent -> accum 1.
TRAIN_ACCUM = {
    "qwen1.5-110b": 4,
    "granite-20b": 2,
    "gemma3-12b": 4,
    "phi3.5-moe-42b-a6.6b": 2,
    "granite-moe-1b-a400m": 2,
    "phi-3-vision-4.2b": 2,
    "zamba2-7b": 2,
    "mamba2-130m": 2,
}

# a block size no sequence reaches
WHOLE = 1 << 30


def _mesh_for(name: str, device):
    return mesh_mod.make_dryrun_mesh(*mesh_mod.production_shape(name == "multipod"), device)


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes
               for t in _tensors(tree))


def _place(tree, specs, mesh):
    """A tree of meta tensors as DTensors on ``mesh`` with ``specs``'
    placements, each holding a meta local shard of rank 0's shape."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        places = shd.placements(spec, mesh)
        local_shape = list(t.shape)
        for size, place in zip(tuple(mesh.shape), places):
            if place.is_shard():  # rank 0 holds the first chunk
                local_shape[place.dim] = -(-local_shape[place.dim] // size)
        local = torch.empty(local_shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, places, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return _map2(one, tree, specs)


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and the spec tree of its structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, sp) for v, sp in zip(tree, specs))
    return fn(tree, specs)


def _to_specs(tree, specs, mesh):
    """The caches a step returns, brought to their specs' placements."""
    return _map2(lambda t, spec: t.redistribute(mesh, shd.placements(spec, mesh))
                 if hasattr(t, "redistribute") else t, tree, specs)


def trace_cell(arch, cfg, cell: ShapeCell, mesh, *, accum: int = 1, spec_cfg=None,
               forward_only: bool = False):
    """Run ``cell``'s step of ``arch`` at ``cfg`` once on meta shards as
    rank 0 of ``mesh`` (inside a dry-run world); returns (counts,
    memory_analysis, seconds). The placements are those of ``spec_cfg``
    (default ``cfg``), a deeper config whose layers include ``cfg``'s:
    the ZeRO-1 and FSDP size thresholds read the depth. ``forward_only``
    (a train cell): the loss of one microbatch, its forward alone."""
    specs = arch.input_specs(cell, cfg)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        stack.enter_context(steps.activation_policy(arch, cell, mesh))
        # the plain attention as one query block by one key block
        stack.enter_context(ops.plain_attention_blocks(WHOLE, WHOLE))
        model = arch.init(None, cfg, device="meta")
        params_abs = dict(model.named_parameters())
        spec_abs = (params_abs if spec_cfg is None else
                    dict(arch.init(None, spec_cfg, device="meta").named_parameters()))
        stack.enter_context(steps.fsdp_policy(arch, cfg, mesh, spec_abs))
        pspec = shd.param_specs(spec_abs, arch, mesh)
        batch = _place(specs, shd.batch_specs(specs, cell, mesh), mesh)
        params = _place(params_abs, {k: pspec[k] for k in params_abs}, mesh)
        steps.assign(model, params)
        counter = hlo_analysis.RooflineCounter()
        if forward_only:
            steps.trainable(model)
            mb = {k: steps.microbatch(v, 0, accum) for k, v in batch.items()}
            args, outs = (params, batch), ()
            with counter:
                arch.loss_fn(cfg, model, mb, impl="ref")
        elif cell.kind == "train":
            opt_abs = adamw.init(params_abs)
            ospec = shd.opt_state_specs(adamw.init(spec_abs), pspec, mesh, arch)
            ospec = {k: {n: ospec[k][n] for n in params_abs} for k in ("m", "v")}
            opt = {"m": _place(opt_abs["m"], ospec["m"], mesh),
                   "v": _place(opt_abs["v"], ospec["v"], mesh), "step": opt_abs["step"]}
            args = (params, opt, batch)
            fn = steps.make_train_step(arch, cfg, adamw.AdamWConfig(), accum=accum,
                                       impl="ref")
            with counter:
                _, opt, metrics = fn(model, opt, batch)
                metrics = {k: pctx.reduce_partial(v) for k, v in metrics.items()}
            outs = (dict(model.named_parameters()), opt, metrics)
        elif cell.kind == "prefill":
            args = (params, batch)
            extra = cfg.vision.n_patches if getattr(cfg, "vision", None) is not None else 0
            fn = steps.make_prefill(arch, cfg, max_cache_len=cell.seq + extra, impl="ref")
            with torch.no_grad(), counter:
                caches, logits = fn(model, batch)
                caches = _to_specs(caches, shd.cache_specs(caches, arch, cell, mesh), mesh)
                logits = pctx.reduce_partial(logits)
            outs = (caches, logits)
        else:  # decode: one step at the last of cell.seq slots
            enc = dict(enc_len=cell.seq) if arch.is_encdec() else {}
            caches_abs = arch.init_caches(cfg, cell.batch, cell.seq, device="meta", **enc)
            cspec = shd.cache_specs(caches_abs, arch, cell, mesh)
            caches = lm.set_cache_position(_place(caches_abs, cspec, mesh), cell.seq - 1)
            args = (params, caches, batch["token"])
            fn = steps.make_serve_step(arch, cfg, impl="ref")
            with torch.no_grad(), counter:
                caches, token, logits = fn(model, caches, batch["token"])
                caches = _to_specs(caches, cspec, mesh)
                token, logits = pctx.reduce_partial(token), pctx.reduce_partial(logits)
            outs = (caches, token, logits)
        seconds = time.time() - t0
        ins = {_storage(t) for t in _tensors(args)}
        memory = {
            # the inputs the step reads (XLA drops an unused argument)
            "argument_size_in_bytes": sum(_local_bytes(t) for t in _tensors(args)
                                          if _storage(t) in counter.read),
            "output_size_in_bytes": _local_bytes(outs),
            "temp_size_in_bytes": counter.counts.peak_bytes,
            "alias_size_in_bytes": sum(_local_bytes(t) for t in _tensors(outs)
                                       if _storage(t) in ins),
        }
    return counter.counts, memory, seconds


def n_groups(cfg) -> int:
    """The layer groups a config repeats: the LM's pattern repeats, an
    encoder-decoder's layer pairs (encoder and decoder alike deep); 0 when
    the depth does not scale as one number."""
    if hasattr(cfg, "n_groups"):
        return cfg.n_groups
    return cfg.n_dec_layers if cfg.n_enc_layers == cfg.n_dec_layers else 0


def nested(cfg) -> bool:
    """Whether ``cfg`` is counted with the reference's two-level
    recomputation (``scan_nest``; ``count_cell``)."""
    return getattr(cfg, "scan_nest", 1) > 1 and cfg.n_groups % cfg.scan_nest == 0


def with_groups(cfg, g: int):
    """``cfg`` cut to ``g`` layer groups."""
    if hasattr(cfg, "n_groups"):
        return dataclasses.replace(cfg, n_layers=g * len(cfg.pattern))
    return dataclasses.replace(cfg, n_enc_layers=g, n_dec_layers=g)


def count_cell(arch, cfg, cell: ShapeCell, mesh, *, accum: int = 1):
    """``trace_cell``'s (counts, memory_analysis, seconds) for ``cfg`` at
    its full depth of G layer groups. Every group runs the same ops, so
    each count is c(1) + (G - 1) * (c(2) - c(1)) from traces at one and
    two groups, the port's counterpart of the reference multiplying a
    scanned group's body by its trip count.

    A training step of a config with ``scan_nest`` = k > 1 (``nested``)
    is counted as the reference runs it: its two-level ``jax.checkpoint``
    recomputes each of k segments, and within a segment each group, so
    every group's forward runs once more than under one level: G more
    group forwards a microbatch, one group's forward being a microbatch's
    loss at two groups less at one. The port's own step keeps one level of
    recomputation (``lm.forward``): this term is the count's alone. The
    reference's records of the same SMOKE cell at four groups, flat and
    with k = 2, differ by exactly that (``tests/test_torch_dryrun.py``,
    the golden's ``nested`` section). A config of at most two groups is
    traced as it is (the peak of live bytes is the one-level run's)."""
    G = n_groups(cfg)
    if cell.kind == "train" and nested(cfg):
        flat = dataclasses.replace(cfg, scan_nest=1)
        counts, memory, seconds = count_cell(arch, flat, cell, mesh, accum=accum)
        (f1, _, s1), (f2, _, s2) = (
            trace_cell(arch, with_groups(flat, g), cell, mesh, accum=accum, spec_cfg=flat,
                       forward_only=True) for g in (1, 2))
        extra = G * accum  # group forwards, each microbatch's
        return (_combine(counts, (f2, f1), lambda a, b, c: a + extra * (b - c)), memory,
                seconds + s1 + s2)
    if G <= 2:
        return trace_cell(arch, cfg, cell, mesh, accum=accum)
    (c1, m1, s1), (c2, m2, s2) = (trace_cell(arch, with_groups(cfg, g), cell, mesh,
                                             accum=accum, spec_cfg=cfg) for g in (1, 2))

    def scale(a, b, _=None):
        return a + (G - 1) * (b - a)

    return (_combine(c1, (c2,), scale), {k: scale(m1[k], m2[k]) for k in m1}, s1 + s2)


def _combine(c, others, fn):
    """RooflineCounts of ``fn`` applied field by field to ``c`` and
    ``others`` (the peak of live bytes too, but with two others: then
    ``c``'s)."""
    kinds = sorted(set(c.collectives).union(*(o.collectives for o in others)))

    def each(name):
        return fn(getattr(c, name), *(getattr(o, name) for o in others))

    return hlo_analysis.RooflineCounts(
        flops=each("flops"), collective_bytes=each("collective_bytes"),
        collectives={k: fn(c.collectives.get(k, 0.0),
                           *(o.collectives.get(k, 0.0) for o in others)) for k in kinds},
        memory_bytes=each("memory_bytes"),
        warnings=c.warnings + [w for o in others for w in o.warnings],
        transcendentals=each("transcendentals"),
        peak_bytes=c.peak_bytes if len(others) == 2 else each("peak_bytes"))


def _storage(t) -> int:
    local = t.to_local() if hasattr(t, "to_local") else t
    return local.untyped_storage()._cdata


def run_cell(arch_id: str, shape_name: str, mesh_name: str, out_dir: str = OUT_DIR, *,
             device=None) -> dict:
    """One production cell at full width in a fresh dry-run world; its
    record, also written to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "ok": False}
    try:
        device = resolve_device(device)
        arch = get_arch(arch_id)
        with mesh_mod.dryrun_world():
            mesh = _mesh_for(mesh_name, device)
            counts, memory, seconds = count_cell(arch, arch.full, SHAPES[shape_name], mesh,
                                                 accum=TRAIN_ACCUM.get(arch_id, 1))
        rec.update(record(counts, memory, seconds, math.prod(tuple(mesh.shape))))
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def record(counts, memory: dict, seconds: float, n_devices: int) -> dict:
    """The reference's record fields of a traced cell. ``lower_s`` is the
    trace's wall time; ``compile_s`` is 0: nothing is compiled. The
    reference's ``hlo_text_bytes`` has no counterpart (there is no HLO).
    ``memory_analysis``: the arguments the step reads, its outputs and
    the bytes of them that are its inputs updated in place, each rank 0's
    local shards; temp is the counter's peak of live bytes the step
    allocated (``hlo_analysis``)."""
    return {"ok": True, "n_devices": n_devices, "lower_s": round(seconds, 1),
            "compile_s": 0.0, "kernels": "plain", "memory_analysis": memory,
            "cost_analysis": {"flops": counts.flops,
                              "transcendentals": counts.transcendentals},
            "hlo": hlo_analysis.as_record(counts)}


def all_cells():
    for arch_id, arch in ARCHS.items():
        for shape_name in SHAPES:
            if not arch.supports(shape_name):
                continue
            for mesh_name in ("pod", "multipod"):
                yield arch_id, shape_name, mesh_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="where the fake tensors sit (default: the card)")
    args = ap.parse_args(argv)

    if args.all:
        todo = list(all_cells())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape, args.mesh)]

    n_ok = 0
    for arch_id, shape_name, mesh_name in todo:
        path = os.path.join(args.out, f"{arch_id}__{shape_name}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    obs.log(f"SKIP {arch_id} {shape_name} {mesh_name} (cached)")
                    n_ok += 1
                    continue
        t0 = time.time()
        rec = run_cell(arch_id, shape_name, mesh_name, args.out, device=args.device)
        status = "OK " if rec.get("ok") else "FAIL"
        n_ok += bool(rec.get("ok"))
        extra = (
            f"flops/dev={rec['hlo']['flops_per_device']:.3g} "
            f"coll/dev={rec['hlo']['collective_bytes_per_device']:.3g}B"
            if rec.get("ok")
            else rec.get("error", "")[:120]
        )
        obs.log(
            f"{status} {arch_id:24s} {shape_name:12s} {mesh_name:8s} "
            f"t={time.time()-t0:6.1f}s {extra}",
            flush=True,
        )
    obs.log(f"done: {n_ok}/{len(todo)} cells ok")
    return n_ok, len(todo)


if __name__ == "__main__":
    main()
