"""repro_torch.obs — the flight recorder of the fleet and the model path.

Low-overhead observability for the planning/fleet stack and the training
step: structured spans and instant events (:mod:`repro_torch.obs.trace`),
a counters/gauges/histograms registry (:mod:`repro_torch.obs.metrics`), a
per-node Gantt timeline reconstructed from scheduler records
(:mod:`repro_torch.obs.timeline`), and one sanctioned diagnostic emitter
(:mod:`repro_torch.obs.log`).

Spans are stamped on the clock of ``torch.profiler``'s host events
(``trace.profiler_clock_ns``, the wall clock in integer ns). Exported
``ts``/``dur`` are µs from the recorder's epoch, and ``export_run``'s
``meta.epoch_ns`` is that epoch on the profiler's clock, so
``epoch_ns + ts * 1e3`` puts a span on the axis of a profiled stretch's
runtime calls and kernels. Each span's ``args`` hold its ``id`` and its
``parent`` (the id of the span that caused it), and the spans of one
training step share its ``step``.

The model path's spans (category ``train``): ``train.step`` around one
call of ``launch.train.make_compressed_dp_step``'s step, with ``args.step``
counted by the step; inside it ``train.loss_and_grads``,
``train.compress`` (``compressed_grad_tree``) and ``train.adamw``
(``adamw.update``), the loss's all-reduce outside the three; and, in
``kernels/ops.py``, ``attention.bwd`` around each flash-attention
backward (the (out, lse) recomputation and the plain backward) and
``ssd.bwd`` around each SSD scan's VJP. On the card autograd runs those
backwards on its own device thread; their parent is still
``train.loss_and_grads``.

Design contract — **off by default, bitwise-off**: every hook in the
engine/fleet stack routes through the module-level helpers below,
which delegate to a process-wide *current* tracer/registry. The
defaults are null objects whose span/counter calls return shared
singletons and record nothing, so an uninstrumented run allocates
nothing per hook, perturbs no RNG, and produces bit-identical results.
Recording is opt-in and scoped::

    from repro_torch import obs

    with obs.recording() as rec:
        report, sched = run_fleet_comparison(...)
    payload = obs.export_run(rec, sched=sched)   # Perfetto-loadable

Instrumented code never imports ``Tracer`` directly — it calls
``obs.span(...)`` / ``obs.counter(...).inc()`` and stays oblivious to
whether a recorder is installed.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Iterator, Optional

from . import metrics as _metrics
from . import timeline as _timeline
from . import trace as _trace
from .log import log
from .metrics import MetricsRegistry, NullMetrics, NULL_METRICS
from .trace import (
    NULL_TRACER,
    NullTracer,
    TRACE_EVENT_KEYS,
    TRACE_SCHEMA_VERSION,
    Tracer,
)

__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "NullMetrics",
    "NullTracer",
    "NULL_METRICS",
    "NULL_TRACER",
    "TRACE_EVENT_KEYS",
    "TRACE_SCHEMA_VERSION",
    "Tracer",
    "counter",
    "enabled",
    "event",
    "export_run",
    "gauge",
    "histogram",
    "log",
    "metrics_registry",
    "recording",
    "span",
    "tracer",
    "write_trace",
]


# -- the hook surface (what instrumented modules call) ----------------

def tracer() -> Any:
    return _trace.current()


def metrics_registry() -> Any:
    return _metrics.current()


def enabled() -> bool:
    """True when a live recorder is installed (either half counts)."""
    return _trace.current().enabled or _metrics.current().enabled


def span(name: str, *, cat: str = "repro",
         sim_t_s: Optional[float] = None, **args: Any) -> Any:
    return _trace.current().span(name, cat=cat, sim_t_s=sim_t_s, **args)


def event(name: str, *, cat: str = "repro",
          sim_t_s: Optional[float] = None, **args: Any) -> None:
    _trace.current().event(name, cat=cat, sim_t_s=sim_t_s, **args)


def counter(name: str) -> Any:
    return _metrics.current().counter(name)


def gauge(name: str) -> Any:
    return _metrics.current().gauge(name)


def histogram(name: str) -> Any:
    return _metrics.current().histogram(name)


# -- recording sessions ----------------------------------------------

class FlightRecorder:
    """One recording session: a live tracer plus a live registry."""

    def __init__(self, capacity: int = 65536):
        self.trace = Tracer(capacity=capacity)
        self.metrics = MetricsRegistry()


@contextlib.contextmanager
def recording(capacity: int = 65536) -> Iterator[FlightRecorder]:
    """Install a :class:`FlightRecorder` process-wide for the block.

    The previous tracer/registry (normally the nulls) are restored on
    exit, so recording scopes nest and never leak into later runs.
    """
    rec = FlightRecorder(capacity=capacity)
    prev_tracer = _trace.install(rec.trace)
    prev_metrics = _metrics.install(rec.metrics)
    try:
        yield rec
    finally:
        _trace.install(prev_tracer)
        _metrics.install(prev_metrics)


def export_run(rec: FlightRecorder, *, sched: Any = None) -> Dict[str, Any]:
    """Assemble one Perfetto-loadable payload for a recorded run.

    ``traceEvents`` holds the live span/event stream plus (when a
    scheduler is given) the reconstructed per-node timeline lanes;
    ``metrics`` is the registry rollup and ``timeline`` the raw segment
    rows. Extra top-level keys are legal in the trace-event format, so
    the one file serves both the viewer and ``python -m repro_torch.obs``.
    """
    events = rec.trace.events()
    segments = _timeline.build_timeline(sched) if sched is not None else []
    payload: Dict[str, Any] = {
        "traceEvents": events + _timeline.to_trace_events(segments),
        "displayTimeUnit": "ms",
        "meta": {
            "schema_version": TRACE_SCHEMA_VERSION,
            "epoch_ns": rec.trace.epoch_ns,
            "n_span_events": len(events),
            "n_dropped_events": rec.trace.n_dropped,
            "n_timeline_segments": len(segments),
        },
        "metrics": rec.metrics.snapshot(),
        "timeline": _timeline.to_json(segments),
    }
    if segments:
        payload["meta"]["node_busy_s"] = _timeline.node_utilization(segments)
    return payload


def write_trace(path: str, rec: FlightRecorder, *,
                sched: Any = None) -> Dict[str, Any]:
    """Export a recorded run to ``path`` as JSON; returns the payload."""
    payload = export_run(rec, sched=sched)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=float)
    return payload
