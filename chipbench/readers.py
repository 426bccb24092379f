"""What the per-layer metric readers (``chipbench/metrics/*.py``) share.

A reader takes the traced run's record: ``steps``, one entry a step or
batch of the window ({b, s, ms: its time on the device between CUDA
events, spans: {call: ms}, launches: {kernel: count}, profiled: whether
the profiler saw it}), ``trace`` (the profiled stretch reduced by
``chipbench/trace.py``), ``peak_bytes`` (the window's peak of allocated
device memory), ``config`` and ``traffic``. It returns a number, or None
where it finds nothing to read.
"""

from __future__ import annotations

import statistics

from chipbench import flops


def span_ms(rec, name):
    """The mean of a span over the window's steps that the profiler did not
    slow."""
    times = [s["spans"][name] for s in rec["steps"]
             if name in s.get("spans", {}) and not s["profiled"]]
    return statistics.fmean(times) if times else None


def mfu(rec, work, peak):
    """Model FLOPs of the window's steps (``work(config, b, s)``) over their
    device time, as a percentage of ``peak``; the steps the profiler slowed
    are left out."""
    steps = [s for s in rec["steps"] if s.get("ms", 0) > 0 and not s["profiled"]]
    if not steps:
        return None
    ops = sum(work(rec["config"], s["b"], s["s"]) for s in steps)
    return 100.0 * ops / (sum(s["ms"] for s in steps) / 1e3) / peak


def roofline(rec, kernel, pattern, launch_work, peak):
    """The least time of the profiled launches of ``kernel`` (each launch's
    ``launch_work(config, b, s)`` at its step's shapes, bounded by ``peak``
    or the memory's rate) over the device time of the trace's kernels whose
    name holds ``pattern``, as a percentage."""
    profiled = [s for s in rec["steps"] if s["profiled"] and s["launches"].get(kernel)]
    busy = sum(t for name, t in rec["trace"]["kernels"].items() if pattern in name)
    if not profiled or busy <= 0:
        return None
    least = sum(s["launches"][kernel] * flops.bound_s(*launch_work(rec["config"], s["b"], s["s"]),
                                                      peak)
                for s in profiled)
    return 100.0 * least / busy


def idle_pct(rec):
    t = rec["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_gib(rec):
    return None if rec["peak_bytes"] is None else rec["peak_bytes"] / 2**30
