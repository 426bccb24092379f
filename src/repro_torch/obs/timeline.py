"""Per-node Gantt timeline reconstructed from the fleet's own records.

The scheduler already keeps everything a Gantt chart needs — completed
jobs (``FleetScheduler.completed``), tentative holds and preemption
records (``TelemetryHub``) — it just never assembles them. This module
turns those records into a flat list of :class:`Segment` rows (one per
occupancy interval per node, on the *sim* clock) and renders them two
ways: plain JSON for programmatic consumers, and Chrome trace events
(one ``tid`` lane per node, sim-seconds mapped to trace microseconds)
so the whole fleet run is scrubbable in Perfetto next to the live
span stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from .trace import TIMELINE_PID

# Segment kinds, in render order within a lane.
KIND_RUN = "run"  # a (finished) execution segment
KIND_PREEMPTED = "preempted"  # a segment abandoned by migration
KIND_HOLD = "hold"  # a tentative lookahead reservation


@dataclasses.dataclass(frozen=True)
class Segment:
    """One occupancy interval on one node, on the sim clock."""

    node: str
    job_id: int
    kind: str  # one of KIND_RUN / KIND_PREEMPTED / KIND_HOLD
    start_s: float
    end_s: float
    cores: int
    app: str = ""


def build_timeline(sched: Any) -> List[Segment]:
    """Reconstruct the per-node timeline from a finished scheduler.

    ``sched`` is a ``FleetScheduler`` after ``run()`` (or any number of
    ``step()`` calls): completed jobs become ``run`` segments, telemetry
    preemption records become ``preempted`` segments (the abandoned
    partial work), and tentative records become ``hold`` segments.
    Deterministically sorted so two identical runs export identically.
    """
    segments: List[Segment] = []
    for c in getattr(sched, "completed", ()):
        p = c.placement
        segments.append(Segment(
            node=p.node,
            job_id=p.job.job_id,
            kind=KIND_RUN,
            start_s=p.start_s,
            end_s=c.finish_s,
            cores=p.cores,
            app=p.job.app,
        ))
    hub = getattr(sched, "telemetry", None)
    if hub is not None:
        for rec in getattr(hub, "preemptions", ()):
            segments.append(Segment(
                node=rec.from_node,
                job_id=rec.job_id,
                kind=KIND_PREEMPTED,
                start_s=rec.start_s,
                end_s=rec.time_s,
                cores=rec.cores,
                app=rec.family[0],
            ))
        for rec in getattr(hub, "tentatives", ()):
            segments.append(Segment(
                node=rec.node,
                job_id=rec.job_id,
                kind=KIND_HOLD,
                start_s=rec.start_s,
                end_s=rec.end_s,
                cores=rec.cores,
                app=rec.family[0],
            ))
    segments.sort(key=lambda s: (s.node, s.start_s, s.end_s, s.job_id, s.kind))
    return segments


def to_json(segments: List[Segment]) -> List[Dict[str, Any]]:
    return [dataclasses.asdict(s) for s in segments]


def to_trace_events(segments: List[Segment]) -> List[Dict[str, Any]]:
    """Render the timeline as Chrome trace events, one lane per node.

    Sim seconds map to trace microseconds (ts = start_s × 1e6), so the
    Perfetto ruler reads sim-microseconds; real sim values ride in
    ``args``. Lanes live under ``pid = TIMELINE_PID`` with thread-name
    metadata so viewers label each lane with its node.
    """
    nodes = sorted({s.node for s in segments})
    tid_of = {node: i + 1 for i, node in enumerate(nodes)}
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name", "cat": "__metadata", "ph": "M",
            "ts": 0.0, "dur": 0.0, "pid": TIMELINE_PID, "tid": 0,
            "args": {"name": "fleet timeline (sim clock)"},
        },
    ]
    for node in nodes:
        events.append({
            "name": "thread_name", "cat": "__metadata", "ph": "M",
            "ts": 0.0, "dur": 0.0, "pid": TIMELINE_PID,
            "tid": tid_of[node], "args": {"name": node},
        })
    for s in segments:
        events.append({
            "name": f"{s.app}#{s.job_id}" if s.app else f"job#{s.job_id}",
            "cat": f"timeline.{s.kind}",
            "ph": "X",
            "ts": s.start_s * 1e6,
            "dur": max(s.end_s - s.start_s, 0.0) * 1e6,
            "pid": TIMELINE_PID,
            "tid": tid_of[s.node],
            "args": {
                "job_id": s.job_id, "kind": s.kind, "cores": s.cores,
                "start_s": s.start_s, "end_s": s.end_s,
            },
        })
    return events


def node_utilization(segments: List[Segment]) -> Dict[str, float]:
    """Per-node busy seconds from ``run`` + ``preempted`` segments —
    the CLI summary's quick read on how evenly work spread."""
    busy: Dict[str, float] = {}
    for s in segments:
        if s.kind == KIND_HOLD:
            continue
        busy[s.node] = busy.get(s.node, 0.0) + max(s.end_s - s.start_s, 0.0)
    return dict(sorted(busy.items()))
