"""The profiler's trace of a traced window, reduced to what the per-layer
readers and the ``breakdown`` take.

The device is busy where any kernel, copy or set runs: the union of the
device events' intervals (user annotations left out), as
``scripts/trace_decode_torch.py`` takes it. The window runs from the first
event to the last, which is the synchronise that closes it. An idle gap is
named after the outermost host event running at its middle: a CUDA
runtime call (a launch, a copy, a synchronise), or "no host operation"
where the host ran Python and the dispatcher between calls.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

TOP = 10


def activities(device):
    """The device's activity alone (CUDA kernels, copies, sets and the
    runtime calls that launch them): recording every host operation as
    well doubled a profiled training step's time on the host, and the
    device's idle share with it."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA if str(device).startswith("cuda") else ProfilerActivity.CPU]


def _union(intervals: List[Tuple[int, int]]):
    """(total covered, the gaps between covered stretches)."""
    total, end, gaps = 0, None, []
    for start, stop in sorted(intervals):
        if end is not None and start > end:
            gaps.append((end, start))
        if end is None or stop > end:
            total += stop - (start if end is None else max(start, end))
            end = stop
    return total, gaps


def reduce(prof) -> dict:
    """{busy_s, window_s, kernels {name: s}, device_ops [[name, s]],
    idle_gaps [[host op, s]]} of a finished ``torch.profiler.profile``
    (all empty for None)."""
    from torch.autograd import DeviceType

    device, host = [], []
    if prof is None:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    t_lo, t_hi = None, None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        t_lo = start if t_lo is None else min(t_lo, start)
        t_hi = end if t_hi is None else max(t_hi, end)
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CPU:
            host.append((start, end, e.name()))
    if t_lo is None:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "device_ops": [],
                "idle_gaps": []}
    busy, gaps = _union([(s, e) for _, s, e in device])
    if device:  # the stretches before the first and after the last device event
        first, last = min(s for _, s, _ in device), max(e for _, _, e in device)
        gaps = [(t_lo, first)] + gaps + [(last, t_hi)]
    kernels: Dict[str, float] = collections.Counter()
    for name, s, e in device:
        kernels[name] += (e - s) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (t_hi - t_lo) / 1e9, "kernels": dict(kernels),
            "device_ops": [[n, s] for n, s in kernels.most_common(TOP)],
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> list:
    """Idle time summed by the outermost host operation running at each
    gap's middle; the TOP longest."""
    outer = []  # host operations not inside another, by start
    for start, end, name in sorted(host):
        if outer and start < outer[-1][1]:
            continue
        outer.append((start, end, name))
    starts = [o[0] for o in outer]
    by_name: Dict[str, float] = collections.Counter()
    for lo, hi in gaps:
        if hi <= lo:
            continue
        mid = (lo + hi) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = outer[i][2] if i >= 0 and outer[i][1] > mid else "no host operation"
        by_name[name] += (hi - lo) / 1e9
    return [[n, s] for n, s in by_name.most_common(TOP)]
