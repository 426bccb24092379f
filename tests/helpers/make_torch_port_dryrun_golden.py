"""Write ``tests/data/torch_port_dryrun_golden.json``: the JAX package's
dry-run records, for ``tests/test_torch_dryrun.py`` and ``chip_smoke.py``
phase 11 (the card has no JAX).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/helpers/make_torch_port_dryrun_golden.py

Two sections, each keyed "<arch>__<shape>__<mesh>":

* ``full``: every cell of the reference's ``dryrun.all_cells()`` (66: ten
  archs x three shapes, plus long_500k for the three archs that take it,
  on the pod and multipod meshes), each from the reference's own
  ``run_cell`` in a process of its own (``launch/dryrun.py`` forces 512
  host devices at import).
* ``smoke``: the ten archs x {train, prefill, decode} at SMOKE width on
  a (2, 4) ("data", "model") mesh of 8 host devices, with the cells of
  ``SMOKE_CELLS``; each is lowered and compiled branch for branch as the
  reference's ``_lower_cell`` does, with ``cfg=arch.smoke`` and the
  cell's own input specs, and counted with ``hlo_analysis.analyze``.
* ``nested``: the SMOKE train cell of the archs of ``NESTED`` cut to four
  layer groups, with one level of recomputation (``scan_nest`` 1) and
  with two (``scan_nest`` 2): what the reference's two-level
  ``jax.checkpoint`` adds to a step's counts. ``--nested-only`` computes
  this section alone and keeps the rest of the file (about 40 s).

Under jax 0.9 ``jax.make_mesh`` (the reference's mesh over every device:
multipod, and the SMOKE mesh of 8) makes Explicit axes, which the
reference's ``with_sharding_constraint`` refuses: 10 of the 33 multipod
cells fail so. Those, and the SMOKE cells, run on a mesh with Auto axes,
as jax 0.4.x made it (``full_cell``, ``AUTO_MESH``).

A record keeps what the port is held to: ``ok``, ``n_devices``,
``memory_analysis``, ``cost_analysis`` and ``hlo`` (or ``error`` for a
cell the reference fails), and ``lower_s`` / ``compile_s`` for reading.
``--smoke-cell ARCH KIND`` prints one SMOKE record as JSON and writes
nothing (the test that keeps this file honest runs it).

On an 8-core host with jax 0.9.0, four cells at a time, the whole file
took 5.5 minutes: the 30 SMOKE cells 76 s, the 66 full cells the rest (3
to 15 s a process; the 10 multipod cells that ``jax.make_mesh`` refuses
run twice). The ``nested`` section alone (``--nested-only``) took 16 s.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "..", "src")
OUT = os.path.join(HERE, "..", "data", "torch_port_dryrun_golden.json")

# (seq, batch) of the SMOKE cells; the batch splits over the (2, 4) mesh's
# data axis at every arch's TRAIN_ACCUM
SMOKE_CELLS = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}
SMOKE_MESH = ((2, 4), ("data", "model"))
# (arch, layer groups, scan_nest) of the ``nested`` section's SMOKE train
# cells: two dense archs whose one-level SMOKE counts meet the port's
NESTED = [(a, 4, k) for a in ("qwen1.5-110b", "granite-20b") for k in (1, 2)]
KEEP = ("ok", "n_devices", "memory_analysis", "cost_analysis", "hlo", "error",
        "lower_s", "compile_s")


def _env(n_devices: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return env


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# jax.make_mesh with every axis Auto, as jax 0.4.x made it; the reference's
# make_mesh calls jax.make_mesh when the mesh takes every device
AUTO_MESH = ("import jax, numpy as np\n"
             "from jax.sharding import Mesh\n"
             "jax.make_mesh = lambda shape, axes, *a, **k: Mesh(\n"
             "    np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)\n")


def _run_cell(arch_id: str, shape_name: str, mesh_name: str, auto: bool) -> dict:
    code = ("import json, sys, tempfile\n"
            "from repro.launch import dryrun\n" + (AUTO_MESH if auto else "") +
            "rec = dryrun.run_cell(*sys.argv[1:4], out_dir=tempfile.mkdtemp())\n"
            "print(json.dumps(rec))\n")
    r = subprocess.run([sys.executable, "-c", code, arch_id, shape_name, mesh_name],
                       env=_env(512), capture_output=True, text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"{arch_id} {shape_name} {mesh_name}: {r.stderr[-2000:]}")
    rec = _last_json(r.stdout)
    return {k: rec[k] for k in KEEP if k in rec}


def full_cell(arch_id: str, shape_name: str, mesh_name: str) -> dict:
    """The reference's ``run_cell`` in a fresh process (it forces 512
    host devices at import); its record, trimmed to ``KEEP``. Under jax
    0.9 ``jax.make_mesh`` makes Explicit axes, which the reference's
    ``with_sharding_constraint`` refuses, and the multipod mesh (all 512
    devices) comes from it: such a failure is kept as
    ``reference_error`` and the cell run again with Auto axes
    (``AUTO_MESH``), as the reference ran it under jax 0.4.x
    (``"mesh_axis_types": "Auto"``)."""
    rec = _run_cell(arch_id, shape_name, mesh_name, auto=False)
    if not rec["ok"] and "Auto axes" in rec.get("error", ""):
        err = rec["error"]
        rec = _run_cell(arch_id, shape_name, mesh_name, auto=True)
        rec.update(reference_error=err, mesh_axis_types="Auto")
    return rec


def nested_key(arch_id: str, groups: int, scan_nest: int) -> str:
    return f"{arch_id}__smoke_train_g{groups}_nest{scan_nest}__2x4"


def smoke_record(arch_id: str, kind: str, groups: int = 0, scan_nest: int = 1) -> dict:
    """One SMOKE cell lowered and compiled in this process (which must
    see 8 host devices), as the reference's ``_lower_cell`` does;
    ``groups`` > 0 cuts the SMOKE config to that many layer groups with
    ``scan_nest``."""
    import contextlib
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from jax.sharding import Mesh

    from repro.configs import get_arch
    from repro.configs.base import ShapeCell
    from repro.launch import hlo_analysis, steps
    from repro.launch.dryrun import TRAIN_ACCUM
    from repro.optim import adamw
    from repro.parallel import sharding as shd

    arch = get_arch(arch_id)
    cfg = arch.smoke
    if groups:
        cfg = dataclasses.replace(cfg, n_layers=groups * len(cfg.pattern), scan_nest=scan_nest)
    seq, batch = SMOKE_CELLS[kind]
    cell = ShapeCell(f"smoke_{kind}", seq, batch, kind)
    # the reference's make_mesh would call jax.make_mesh here (the mesh
    # takes every device), whose Explicit axes jax 0.9 refuses in
    # with_sharding_constraint: the mesh with Auto axes, as in AUTO_MESH
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(SMOKE_MESH[0]), SMOKE_MESH[1])
    sds, i32 = jax.ShapeDtypeStruct, jnp.int32
    # the cell's input specs, as ArchDef.input_specs builds them for a
    # named shape
    if arch.is_encdec():
        tok_len = min(seq, cfg.max_target_len)
        specs = {"token": sds((batch, 1), i32)} if kind == "decode" else {
            "frames": sds((batch, seq, cfg.d_model), jnp.bfloat16),
            "tokens": sds((batch, tok_len), i32)}
        if kind == "train":
            specs["labels"] = sds((batch, tok_len), i32)
    elif kind == "decode":
        specs = {"token": sds((batch, 1), i32)}
    else:
        specs = {"tokens": sds((batch, seq), i32)}
        if kind == "train":
            specs["labels"] = sds((batch, seq), i32)
        if cfg.vision is not None:
            specs["images"] = sds((batch, cfg.vision.n_patches, cfg.vision.d_vision),
                                  jnp.bfloat16)
    rec = {"ok": False}
    t0 = time.time()
    try:
        with mesh, steps.activation_policy(arch, cell, mesh), contextlib.ExitStack() as stack:
            if kind == "train":
                params_abs, opt_abs = steps.abstract_train_state(arch, cfg)
                stack.enter_context(steps.fsdp_policy(arch, cfg, mesh, params_abs))
                pshard, oshard, bshard = steps.train_shardings(
                    arch, cfg, mesh, cell, params_abs, opt_abs, specs)
                fn = steps.make_train_step(arch, cfg, adamw.AdamWConfig(),
                                           zero_shardings=oshard["m"],
                                           accum=TRAIN_ACCUM.get(arch_id, 1))
                lowered = jax.jit(fn, in_shardings=(pshard, oshard, bshard),
                                  out_shardings=(pshard, oshard, None),
                                  donate_argnums=(0, 1)).lower(params_abs, opt_abs, specs)
            else:
                params_abs = jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0), cfg))
                stack.enter_context(steps.fsdp_policy(arch, cfg, mesh, params_abs))
                pshard = steps.named(mesh, shd.param_specs(params_abs, arch, mesh))
                if kind == "prefill":
                    bshard = steps.named(mesh, shd.batch_specs(specs, cell, mesh))
                    extra = cfg.vision.n_patches if getattr(cfg, "vision", None) else 0
                    fn = steps.make_prefill(arch, cfg, max_cache_len=seq + extra)
                    caches_abs = jax.eval_shape(fn, params_abs, specs)[0]
                    cshard = steps.named(mesh, shd.cache_specs(caches_abs, arch, cell, mesh))
                    lowered = jax.jit(fn, in_shardings=(pshard, bshard),
                                      out_shardings=(cshard, None)).lower(params_abs, specs)
                else:
                    if arch.is_encdec():
                        caches_abs = jax.eval_shape(
                            lambda: arch.init_caches(cfg, batch, seq, seq))
                    else:
                        caches_abs = jax.eval_shape(lambda: arch.init_caches(cfg, batch, seq))
                    cshard = steps.named(mesh, shd.cache_specs(caches_abs, arch, cell, mesh))
                    tshard = steps.named(mesh, shd.batch_specs(specs, cell, mesh))
                    fn = steps.make_serve_step(arch, cfg)
                    lowered = jax.jit(fn, in_shardings=(pshard, cshard, tshard["token"]),
                                      out_shardings=(cshard, None, None),
                                      donate_argnums=(1,)).lower(params_abs, caches_abs,
                                                                 specs["token"])
        t_lower = time.time() - t0
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        cost = compiled.cost_analysis()
        counts = hlo_analysis.analyze(compiled.as_text())
        rec.update(
            ok=True, n_devices=int(np.prod(mesh.devices.shape)),
            lower_s=round(t_lower, 1), compile_s=round(time.time() - t0 - t_lower, 1),
            memory_analysis={k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                "alias_size_in_bytes") if hasattr(mem, k)},
            cost_analysis={k: float(v) for k, v in (cost or {}).items()
                           if isinstance(v, (int, float)) and k in ("flops", "transcendentals")},
            hlo={"flops_per_device": counts.flops,
                 "memory_bytes_per_device": counts.memory_bytes,
                 "collective_bytes_per_device": counts.collective_bytes,
                 "collectives": dict(counts.collectives),
                 "warnings": counts.warnings[:20]})
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
    return rec


def smoke_cell(arch_id: str, kind: str, groups: int = 0, scan_nest: int = 1) -> dict:
    """``smoke_record`` in a fresh process with 8 host devices."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--smoke-cell", arch_id,
                        kind, "--groups", str(groups), "--scan-nest", str(scan_nest)],
                       env=_env(8), capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"{arch_id} {kind}: {r.stderr[-2000:]}")
    return _last_json(r.stdout)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke-cell", nargs=2, metavar=("ARCH", "KIND"))
    ap.add_argument("--groups", type=int, default=0,
                    help="with --smoke-cell: cut the config to this many layer groups")
    ap.add_argument("--scan-nest", type=int, default=1,
                    help="with --smoke-cell and --groups: the config's scan_nest")
    ap.add_argument("--nested-only", action="store_true",
                    help="recompute the nested section alone, keep the rest of the file")
    ap.add_argument("--jobs", type=int, default=4, help="cells run at a time")
    args = ap.parse_args()
    if args.smoke_cell:
        print(json.dumps(smoke_record(*args.smoke_cell, args.groups, args.scan_nest)))
        return
    sys.path.insert(0, SRC)
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro.configs import ARCHS
    from repro.configs.base import SHAPES

    full = [(a, s, m) for a, arch in ARCHS.items() for s in SHAPES
            if arch.supports(s) for m in ("pod", "multipod")]
    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        nested = dict(zip([nested_key(*c) for c in NESTED],
                          pool.map(lambda c: smoke_cell(c[0], "train", *c[1:]), NESTED)))
    print(f"nested: {len(nested)} cells, {time.time() - t0:.0f} s", flush=True)
    if args.nested_only:
        with open(OUT) as f:
            out = json.load(f)
        out["nested"] = nested
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"wrote the nested section of {OUT}")
        return
    with ThreadPoolExecutor(args.jobs) as pool:
        smoke = dict(zip([f"{a}__smoke_{k}__2x4" for a in ARCHS for k in SMOKE_CELLS],
                         pool.map(lambda ak: smoke_cell(*ak),
                                  [(a, k) for a in ARCHS for k in SMOKE_CELLS])))
        print(f"smoke: {len(smoke)} cells, {time.time() - t0:.0f} s", flush=True)
        recs = pool.map(lambda c: full_cell(*c), full)
        done = {}
        for cell, rec in zip(full, recs):
            done["__".join(cell)] = rec
            print(f"{'__'.join(cell)}: ok={rec['ok']} {time.time() - t0:.0f} s", flush=True)
    out = {"smoke_cells": {k: {"seq": s, "batch": b} for k, (s, b) in SMOKE_CELLS.items()},
           "smoke_mesh": {"shape": list(SMOKE_MESH[0]), "axes": list(SMOKE_MESH[1])},
           "smoke": smoke, "nested": nested, "full": done}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {OUT}: {len(smoke)} SMOKE and {len(done)} full cells in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
