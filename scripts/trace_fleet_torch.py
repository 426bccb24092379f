#!/usr/bin/env python3
"""Trace the PyTorch port's fleet simulation on one card.

    PYTHONPATH=src python3 scripts/trace_fleet_torch.py          # the four runs
    PYTHONPATH=src python3 scripts/trace_fleet_torch.py --service   # and on the service
    PYTHONPATH=src python3 scripts/trace_fleet_torch.py --device cpu --runs quick

For each run of ``python -m repro_torch.fleet`` that ``chip_smoke.py``
holds to its golden (the default run of 32 jobs on the paper's grids,
``--quick``, ``--quick --horizon 600 --burst 3``, ``--quick --fallback``):
one warm-up run, then the run on the host clock without a profiler, then
the run again under ``torch.profiler`` (CPU and CUDA activities), each
ended by a synchronisation. From the trace it prints the run's window, the
card's busy time in it (the union of its kernel, copy and set intervals),
the idle share, the device events, and the device time of the kernels
that took the most; then one JSON line per run. ``--service`` traces each
run twice more: with ``--service`` (the engine scenario alone, on the
event-driven ``SchedulerService``) and with ``--service --journal`` (one
atomic journal commit a batch, under ``build/``); the lockstep run beside
them is the full comparison (the engine, its fallback and the governor
scenarios), as ``chip_smoke.py`` phase 5b runs it. On the card it exits
non-zero when a trace holds no device event; ``--device cpu`` is a dry run
of the script on the host.
"""

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = {
    "default": [],
    "quick": ["--quick"],
    "horizon-burst": ["--quick", "--horizon", "600", "--burst", "3"],
    "fallback": ["--quick", "--fallback"],
}


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def _run(torch, argv, device):
    """One fleet run, its report printing kept off the console; ends with a
    synchronisation. Returns the host seconds."""
    from repro_torch.fleet import __main__ as fleet_main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fleet_main.main(argv + ["--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


SERVICE_MODES = {
    "service": ["--service"],
    "service+journal": ["--service", "--journal",
                        os.path.join(HERE, "..", "build", "trace_fleet_service.json")],
}


def trace_run(torch, name: str, device: str, mode: str = "lockstep") -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    argv = RUNS[name] + SERVICE_MODES.get(mode, [])
    if mode != "lockstep":
        os.makedirs(os.path.join(HERE, "..", "build"), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _run(torch, argv, device)  # warm-up: kernel modules, allocator, caches
    host_s = _run(torch, argv, device)
    with profile(activities=activities) as prof:
        traced_s = _run(torch, argv, device)
    events = [e for e in prof.events() if not getattr(e, "is_user_annotation", False)]
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = _union_us([(e.time_range.start, e.time_range.end) for e in on_card]) / 1e6
    by_name = collections.Counter()
    for e in on_card:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    out = {
        "run": name, "mode": mode, "argv": argv,
        "wall_s_untraced": host_s,
        "wall_s_traced": traced_s,
        "card_busy_s": busy_s,
        "idle_share_traced": 1.0 - busy_s / traced_s,
        "idle_share_untraced": 1.0 - busy_s / host_s,
        "device_events": len(on_card),
        "top_device_ms": dict(by_name.most_common(8)),
    }
    print(f"[trace] fleet {name} ({mode}): {host_s:.3f} s untraced, {traced_s:.3f} s traced; card "
          f"busy {busy_s * 1e3:.3f} ms, idle {out['idle_share_traced']:.6f} of the traced run "
          f"({out['idle_share_untraced']:.6f} of the untraced); {len(on_card)} device "
          f"events", flush=True)
    for kernel, ms in by_name.most_common(8):
        print(f"[trace]   {ms:10.4f} ms  {kernel[:100]}", flush=True)
    if device == "cuda" and not on_card:
        raise RuntimeError(f"fleet {name} ({mode}): the trace holds no device event")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=list(RUNS), choices=list(RUNS))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--service", action="store_true",
                    help="also trace each run with --service and --service --journal")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(f"[trace] {smi}; torch {torch.__version__}", flush=True)
    modes = ["lockstep"] + (list(SERVICE_MODES) if args.service else [])
    for name in args.runs:
        for mode in modes:
            print(json.dumps(trace_run(torch, name, args.device, mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
