"""A training cell of the benchmark traced with the port's own spans.

    python3 scripts/trace_train_spans_torch.py --workload mamba2-130m.train_4k --seed 7
    python3 scripts/trace_train_spans_torch.py --cost --workload starcoder2-3b.train_4k --seed 7

From the root of a checkout, on a machine with a CUDA card. The first
form makes one ``--trace 1`` run of the cell through ``chipbench``'s
harness with ``repro_torch.obs.recording()`` open over the measured
window, lays the recorded spans over the profiler's trace
(``chipbench/program_trace.py``) and prints one JSON line: each span's
count, host, device and idle ms a profiled ``train.step``; the span
metrics that a ``benchmark`` change would read from them; the stretch's
device and idle time and the shares of them inside ``train.step``; and
the cell's result as the harness gives it.

``--cost`` measures what the recorder costs: µs a span in a loop (the
recorder on, and the null recorder), then the cell's training step under
the profiler with the recorder and without, in turns.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what each span metric reads: (span, field)
SPAN_METRICS = {
    "attention_bwd_ms.train": ("attention.bwd", "device_ms"),
    "ssd_bwd_ms.train": ("ssd.bwd", "device_ms"),
    "grad_idle_ms.train": ("train.loss_and_grads", "idle_ms"),
    "compress_idle_ms.train": ("train.compress", "idle_ms"),
    "adamw_idle_ms.train": ("train.adamw", "idle_ms"),
}
LAYER_SPANS = ("train.loss_and_grads", "train.compress", "train.adamw")


def _set_up():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chipbench import run

    for key, rel in run.CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    os.environ.update(run.THREADS)


def per_step(reduced: dict) -> dict:
    """Each span's numbers over the profiled ``train.step`` spans."""
    n = reduced["spans"]["train.step"]["n"]
    return {name: {k: v / n for k, v in row.items()} for name, row in reduced["spans"].items()}


def _share(part: float, whole: float):
    return part / whole if whole > 0 else None


def traced_run(workload: str, seed: int, seconds: float) -> dict:
    import torch

    from chipbench import harness, program_trace
    from repro_torch import obs

    contexts = []

    class Recording(harness.Context):
        """The harness's context with the port's recorder open over the
        window, from the profiler's warm-up to the window's close."""

        def warm_profiler(self):
            super().warm_profiler()
            self.recording = obs.recording()
            self.recorder = self.recording.__enter__()
            contexts.append(self)

        def window_closed(self):
            super().window_closed()
            self.recording.__exit__(None, None, None)

    plain, harness.Context = harness.Context, Recording
    try:
        result = harness.run_cell(workload, seed, seconds, True, device="cuda")
    finally:
        harness.Context = plain
    (ctx,) = contexts
    payload = obs.export_run(ctx.recorder)
    reduced = program_trace.reduce(ctx.profile, {"events": payload["traceEvents"],
                                                 "epoch_ns": payload["meta"]["epoch_ns"]})
    steps = per_step(reduced)
    idle_in_layers = sum(steps[name]["idle_ms"] for name in LAYER_SPANS)
    step = steps["train.step"]
    return {
        "workload": workload, "seed": seed, "device": result["device"]["kind"],
        "torch": torch.__version__, "profiled_steps": reduced["spans"]["train.step"]["n"],
        "n_dropped": payload["meta"]["n_dropped_events"],
        "span_metrics": {m: steps[s][f] for m, (s, f) in SPAN_METRICS.items() if s in steps},
        "spans_a_step": steps,
        "stretch": {"device_ms": reduced["device_ms"], "idle_ms": reduced["idle_ms"],
                    "idle_in_step_share": _share(reduced["spans"]["train.step"]["idle_ms"],
                                                 reduced["idle_ms"]),
                    "device_in_step_share": _share(reduced["spans"]["train.step"]["device_ms"],
                                                   reduced["device_ms"]),
                    "layers_idle_share_of_step_idle": _share(idle_in_layers, step["idle_ms"])},
        "result": result,
    }


def cost(workload: str, seed: int, turns: int) -> dict:
    import torch
    from torch.profiler import profile

    from chipbench import port, spec, trace
    from repro_torch import obs

    n = 100_000

    def us_a_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("train.step", cat="train", step=0):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    null_us = us_a_span()
    with obs.recording(capacity=n):
        live_us = us_a_span()

    bench = spec.Spec(ROOT)
    cfg = bench.config(bench.workload(workload)["config"])
    tr = bench.traffic(bench.workload(workload)["traffic"])
    feeds = bench.load("entries", "train").feeds
    arch, lm_cfg = port.arch_and_config(cfg)
    weights, batch = feeds(cfg, tr, seed, "cuda")
    step, model, opt_state, resid = port.train_state(arch, lm_cfg, weights(), "cuda",
                                                     tr["optimizer"])
    state = [model, opt_state, resid]

    def one_step(i, recorder: bool, profiled: bool):
        toks, labels = batch(i)
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            if profiled:
                stack.enter_context(profile(activities=trace.activities("cuda")))
            if recorder:
                stack.enter_context(obs.recording())
            t0 = time.perf_counter()
            model, opt_state, resid, met = step(*state, {"tokens": toks, "labels": labels})
            state[:] = [model, opt_state, resid]
            float(met["loss"])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    for i in range(3):  # warm-up, the profiler's first start among them
        one_step(i, False, i == 2)
    rows, i = [], 3
    for turn in range(turns):
        for recorder in ((False, True) if turn % 2 == 0 else (True, False)):
            for profiled in (False, True):
                rows.append({"turn": turn, "recorder": recorder, "profiled": profiled,
                             "step_ms": one_step(i, recorder, profiled)})
                i += 1
    return {"workload": workload, "seed": seed, "device": torch.cuda.get_device_name(),
            "torch": torch.__version__, "null_us_a_span": null_us,
            "live_us_a_span": live_us, "steps": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    _set_up()
    import torch

    if not torch.cuda.is_available():
        print("trace_train_spans_torch: needs a CUDA card", file=sys.stderr)
        return 2
    out = (cost(args.workload, args.seed, args.turns) if args.cost
           else traced_run(args.workload, args.seed, args.seconds))
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
