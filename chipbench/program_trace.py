"""The port's own spans (``repro_torch.obs``) laid over the profiler's trace
of a traced stretch.

The recorder stamps its spans on the clock of the profiler's host events,
so a span's host interval is ``epoch_ns + ts`` to ``epoch_ns + ts + dur``
on the axis of the trace's runtime calls and kernels. For each span name,
over the spans that lie inside the profiled stretch:

- ``n``: how many;
- ``host_ms``: their host intervals summed;
- ``device_ms``: the device time of the kernels, copies and sets whose
  launching runtime call (matched by correlation id) starts inside a span;
- ``idle_ms``: the device's idle time that falls inside a span's host
  interval, the gaps between device intervals taken as
  ``chipbench/trace.py`` takes them.

All four are inclusive: a kernel launched in ``attention.bwd`` counts for
``train.loss_and_grads`` and ``train.step`` too. ``device_ms`` and
``idle_ms`` of the whole stretch sit beside the spans.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Optional

from chipbench import trace

# the host events that launch device work are the CUDA API's calls, the
# runtime's and the lower level's (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...);
# other host events (operators, where the host's activity is traced too)
# carry ids of their own
LAUNCH_PREFIX = "cu"


class Event(NamedTuple):
    kind: str  # "device" (kernel, copy, set), "launch" (a runtime call) or "host"
    start_ns: int
    end_ns: int
    correlation: int


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


def profiler_events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``, user
    annotations left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            kind = "device"
        elif e.name().startswith(LAUNCH_PREFIX):
            kind = "launch"
        else:
            kind = "host"
        out.append(Event(kind, e.start_ns(), e.end_ns(), e.correlation_id()))
    return out


def recorded_spans(program: Optional[dict]) -> List[Span]:
    """The complete spans of a recording (``{"events": export_run's
    traceEvents, "epoch_ns": its meta's}``) on the profiler's clock; none
    where the recorder gives no epoch on that clock."""
    if not program or program.get("epoch_ns") is None:
        return []
    epoch = program["epoch_ns"]
    # pid 1 is the recorder's live lane (a scheduler's timeline is pid 2)
    return [Span(e["name"], epoch + round(e["ts"] * 1e3), epoch + round((e["ts"] + e["dur"]) * 1e3))
            for e in program["events"] if e["ph"] == "X" and e["pid"] == 1]


def reduce(prof, program: Optional[dict]) -> dict:
    """``reduce_events`` of a finished profile and a recording; {} where
    either is missing."""
    spans = recorded_spans(program)
    if prof is None or not spans:
        return {}
    return reduce_events(profiler_events(prof), spans,
                         opened_ns=prof.profiler.kineto_results.trace_start_ns())


def reduce_events(events: List[Event], spans: List[Span], opened_ns: Optional[int] = None) -> dict:
    """{spans: {name: {n, host_ms, device_ms, idle_ms}}, device_ms,
    idle_ms}, the last two over the whole stretch (from the first event
    to the last, as ``trace.py`` takes it); {} without events. A span
    counts from ``opened_ns`` on, where the profiler began recording
    before its first event."""
    if not events:
        return {}
    lo, hi = min(e.start_ns for e in events), max(e.end_ns for e in events)
    first_kept = lo if opened_ns is None else min(lo, opened_ns)
    device = [e for e in events if e.kind == "device"]
    _, gaps = trace._union([(e.start_ns, e.end_ns) for e in device])
    if device:  # as trace.py: the stretches before the first and after the last device event
        lo_dev, hi_dev = min(e.start_ns for e in device), max(e.end_ns for e in device)
        gaps = [(lo, lo_dev)] + gaps + [(hi_dev, hi)]
    else:
        gaps = [(lo, hi)]
    idle_before = _cumulative(gaps)

    launched_at = {e.correlation: e.start_ns for e in events if e.kind == "launch"}
    launches = sorted((launched_at[e.correlation], e.end_ns - e.start_ns) for e in device
                      if e.correlation in launched_at)
    starts = [t for t, _ in launches]
    device_before = [0]
    for _, d in launches:
        device_before.append(device_before[-1] + d)

    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: {"n": 0, "host_ms": 0.0, "device_ms": 0.0, "idle_ms": 0.0})
    for s in spans:
        if s.start_ns < first_kept or s.end_ns > hi:
            continue
        row = out[s.name]
        row["n"] += 1
        row["host_ms"] += (s.end_ns - s.start_ns) / 1e6
        first = bisect.bisect_left(starts, s.start_ns)
        last = bisect.bisect_left(starts, s.end_ns)
        row["device_ms"] += (device_before[last] - device_before[first]) / 1e6
        row["idle_ms"] += (idle_before(s.end_ns) - idle_before(s.start_ns)) / 1e6
    return {"spans": dict(out), "device_ms": sum(e.end_ns - e.start_ns for e in device) / 1e6,
            "idle_ms": idle_before(hi) / 1e6}


def _cumulative(gaps):
    """t -> the length of ``gaps`` (sorted, disjoint) before t."""
    gaps = [(a, b) for a, b in gaps if b > a]
    starts = [a for a, _ in gaps]
    before = [0]
    for a, b in gaps:
        before.append(before[-1] + b - a)

    def at(t: int) -> int:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        a, b = gaps[i]
        return before[i] + min(t, b) - a

    return at
