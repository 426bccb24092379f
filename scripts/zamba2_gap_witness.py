#!/usr/bin/env python3
"""The two readings behind zamba2-7b.prefill_mix's check limits, rerun.

    python3 scripts/zamba2_gap_witness.py depth [--seed N] [--depths 8 27 54 81]
    python3 scripts/zamba2_gap_witness.py f32 [--seed N]   # on one card

The cell compares the port's bf16 prefill with the plain float32 reference
(``chipbench/reference/zamba2.py``): ``token_gap`` (how far a served first
token's reference logit lies below the best) and ``kv_gap`` (the relative
L2 gap of the last shared call's K and V). Both read wide on every seed
(``chipbench/limits/zamba2-7b.prefill_mix.json``). Two arms say why:

* ``depth`` (the host): the harness at the SMOKE widths of
  ``chipbench/tests/data/smoke-zamba2.json`` (d 64) at growing depth, the
  hybrid layers at the published ids below the depth (the SMOKE file's at
  8), the port in bf16 and in float32 against the same reference. If bf16
  round-off grows with depth in the random-weight model, the bf16 gaps
  grow with the layers while the float32 gaps stay at round-off.
* ``f32`` (one card): the cell at its published widths with the port's
  weights and activations in float32, on fewer rows a batch (2 x 1,024
  and 1 x 4,096; float32 weights take 29.4 GB). If the port computes what
  the reference computes, both gaps fall to round-off (under 1e-3); it
  exits non-zero otherwise.

One line a reading, then one JSON object, also written to
``chiprun_out/zamba2_gap_witness_<arm>.json``.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zamba2-7b.prefill_mix"
# Zamba2-7B-Instruct's hybrid_layer_ids
PUBLISHED_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
F32_ROUND_OFF = 1e-3


def _layout(depth: int, smoke_ids) -> dict:
    """The SMOKE file's layout keys at ``depth`` layers."""
    ids = [i for i in PUBLISHED_IDS if i < depth]
    ids = ids if len(ids) >= 3 else list(smoke_ids)
    return {"num_hidden_layers": depth, "hybrid_layer_ids": ids,
            "layers_block_type": ["hybrid" if i in ids else "mamba" for i in range(depth)]}


def depth_arm(seed: int, depths) -> dict:
    from chipbench.tests import smoke

    added = "zamba2-7b" not in smoke.CONFIGS
    smoke.CONFIGS.setdefault("zamba2-7b", "smoke-zamba2.json")
    try:
        smoke_cfg = smoke.config("zamba2-7b")
        rows = [_depth_row(smoke, seed, _layout(depth, smoke_cfg["hybrid_layer_ids"]))
                for depth in depths]
    finally:
        if added:
            del smoke.CONFIGS["zamba2-7b"]
    return {"arm": "depth", "seed": seed, "width": smoke_cfg["hidden_size"], "rows": rows}


def _depth_row(smoke, seed: int, layout: dict) -> dict:
    row = {"layers": layout["num_hidden_layers"],
           "hybrid_layer_ids": layout["hybrid_layer_ids"]}
    for dtype in ("bfloat16", "float32"):
        result = smoke.run(CELL, seed, dtype=dtype, **layout)
        row[dtype] = {k: v["value"] for k, v in result["checks"].items()}
    print(f"[depth] {row['layers']} layers (hybrid at {row['hybrid_layer_ids']}): bf16 "
          f"token_gap {row['bfloat16']['token_gap']:.4g}, kv_gap "
          f"{row['bfloat16']['kv_gap']:.4g}; float32 token_gap "
          f"{row['float32']['token_gap']:.4g}, kv_gap {row['float32']['kv_gap']:.4g}",
          flush=True)
    return row


def f32_arm(seed: int) -> dict:
    import torch

    from chipbench import harness, spec

    if not torch.cuda.is_available():
        raise SystemExit("zamba2_gap_witness f32: no CUDA device")
    bench = spec.Spec(ROOT)
    cfg = dict(bench.config("zamba2-7b"), torch_dtype="float32")
    traffic = dict(bench.traffic("prefill_mix"),
                   buckets=[{"batch": 2, "prompt": 1024, "share": 1},
                            {"batch": 1, "prompt": 4096, "share": 1}],
                   check_requests={"1024": 2, "4096": 1})
    r = harness.run_cell(CELL, seed, 0.0, False, device="cuda", bench=bench, cfg=cfg,
                         traffic=traffic)
    checks = {k: v["value"] for k, v in r["checks"].items()}
    print(f"[f32] the cell in float32 at published widths, seed {seed}: token_gap "
          f"{checks['token_gap']:.4g}, kv_gap {checks['kv_gap']:.4g} (round-off under "
          f"{F32_ROUND_OFF}); peak {r['device']['memory_peak_bytes'] / 1e9:.1f} GB on "
          f"{torch.cuda.get_device_name()}", flush=True)
    return {"arm": "f32", "seed": seed, "checks": checks,
            "memory_peak_bytes": r["device"]["memory_peak_bytes"],
            "ok": all(v < F32_ROUND_OFF for v in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arm", choices=("depth", "f32"))
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--depths", type=int, nargs="+", default=[8, 27, 54, 81])
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        raise SystemExit("zamba2_gap_witness: run from a checkout")
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for path in (ROOT, os.path.join(ROOT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    result = depth_arm(args.seed, args.depths) if args.arm == "depth" else f32_arm(args.seed)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"zamba2_gap_witness_{args.arm}.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if result.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
