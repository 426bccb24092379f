"""The readings a cell's limits are set from that the benchmark's own runs
do not make: the control (the plain reference in the program's place, its
products in fp8, ``reference/precision.py``) and, for a training cell, the
fault of half the batch left out (the reference in the program's place,
each step on the first half of its rows), each judged against the float32
reference as a run judges the program.

    python3 chipbench/calibrate.py --workload starcoder2-3b.train_4k --seeds 11 12 13

One JSON line a seed and reading. For a serving cell ``--batches`` is how
many batches of the mix count as finished, as many as a run's window
finishes; the sample is drawn from them as a run draws it. Its cache is
compared at the reference's last attention layer (``reference/lm.py``
``last_kv_layer``), the layer a run's cache is compared at.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, workload: str, seed: int, device: str, batches: int, cfg=None,
             traffic=None):
    """{reading: {number: value}} of one seed."""
    from chipbench import check
    from chipbench.reference import lm as ref_lm
    from chipbench.reference import precision
    from chipbench.reference import train as ref_train

    cell = bench.workload(workload)
    cfg = cfg or bench.config(cell["config"])
    tr = traffic or bench.traffic(cell["traffic"])
    precision.strict_float32()
    f32, fp8 = precision.Precision("float32"), precision.Precision("fp8")
    entry = bench.load("entries", tr["entry"])
    if tr["entry"] == "train":
        weights, batch = entry.feeds(cfg, tr, seed, device)
        steps = [lambda j=j: batch(j) for j in range(tr["setup_steps"])]
        ref = ref_train.run(cfg, weights, steps, tr["optimizer"], f32)
        control = ref_train.run(cfg, weights, steps, tr["optimizer"], fp8)
        half = ref_train.run(cfg, weights, steps, tr["optimizer"], f32, half_batch=True)
        frozen = ref_train.run(cfg, weights, steps, tr["optimizer"], f32, frozen=True)
        out = {"control": control, "half_batch": half, "unchanged": frozen}
        return {k: dict(check.train_gaps(v, ref), losses=v["losses"], reference=ref["losses"])
                for k, v in out.items()}
    weights, prompts = entry.feeds(cfg, seed, device)
    finished = entry.schedule(tr, seed, batches)
    picked = entry.sample(tr, seed, finished)
    return {"control": entry.judge(cfg, weights, prompts, finished,
                                   {p: (None, None, None) for p in picked},
                                   ref_lm.last_kv_layer(cfg), fp8)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chipbench import spec

    bench = spec.Spec(ROOT)
    for seed in args.seeds:
        for name, numbers in readings(bench, args.workload, seed, args.device,
                                      args.batches).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
