"""Span/event tracer with Chrome/Perfetto trace-event export.

The flight recorder's timing layer. A :class:`Tracer` records *spans*
(named intervals with wall-clock duration and an optional sim-clock
stamp) and *instant events* into a bounded ring buffer, and exports
them as Chrome trace-event JSON — the format ``chrome://tracing`` and
https://ui.perfetto.dev load directly.

Two clocks, deliberately:

- **wall clock** (:func:`profiler_clock_ns`, the clock that
  ``torch.profiler`` stamps its host events with) is the ``ts``/``dur``
  axis of every exported event, in microseconds from the tracer's epoch
  (``Tracer.epoch_ns`` on that clock), so a recorded span and the
  runtime calls and kernels of a profiled stretch lie on one axis;
- **sim clock** (the scheduler's ``now``) rides along in ``args``
  as ``sim_t_s`` so a span can be joined back to the simulated
  timeline it belongs to.

Every span carries ``args.id`` and ``args.parent``, the id of the span
that caused it (None at a root), and takes the args named in
:data:`INHERITED_ARGS` from its parent: the spans of one training step
share its ``step``. The parent is the innermost span still open on the
same thread; a span opened on a thread with none open of its own takes
the innermost span open on any thread, because that thread works for a
caller that waits on it (autograd runs a CUDA backward on its own device
thread while the caller blocks in ``torch.autograd.grad``). An instant
event carries ``args.parent`` alone.

The process-wide default is :data:`NULL_TRACER`: every ``span()`` on
it returns one cached no-op context manager, so uninstrumented runs
allocate nothing per call and stay bitwise-identical to pre-obs
behavior. ``install()`` swaps in a live :class:`Tracer`;
``repro_torch.obs.recording()`` is the supported way to do that with
restore-on-exit semantics.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

# Bumped when the exported event shape changes; pinned by tests so a
# viewer-breaking change is a conscious decision, not drift.
TRACE_SCHEMA_VERSION = 1

# Every exported event carries exactly these keys (uniform shape keeps
# the export trivially diffable and lets tests pin the schema).
TRACE_EVENT_KEYS = ("name", "cat", "ph", "ts", "dur", "pid", "tid", "args")

# Synthetic pid/tid lanes: the recorder is single-process, so pid/tid
# are namespaces, not OS ids. pid 1 = live spans/events, pid 2 = the
# reconstructed per-node timeline (see obs/timeline.py).
TRACE_PID = 1
TRACE_TID = 1
TIMELINE_PID = 2

# args a span takes from its parent unless it sets them itself
INHERITED_ARGS = ("step",)


def profiler_clock_ns() -> int:
    """Now, in integer ns on the clock of ``torch.profiler``'s host events
    (the Unix epoch's wall clock, ``time.time_ns``)."""
    return time.time_ns()


class Span:
    """One in-flight interval; close it (or use ``with``) to record."""

    __slots__ = ("_tracer", "name", "cat", "args", "thread", "_t0_ns", "_done")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.thread = threading.get_ident()
        self._done = False
        tracer._opened(self)
        self._t0_ns = profiler_clock_ns()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc_info: object) -> None:
        self.close()

    def close(self) -> None:
        if self._done:  # idempotent: with-block plus explicit close
            return
        self._done = True
        t1_ns = profiler_clock_ns()
        self._tracer._closed(self)
        self._tracer._record(
            self.name, self.cat, "X",
            self._t0_ns, t1_ns - self._t0_ns, self.args,
        )


class _NullSpan:
    """The no-op span: one shared instance, zero per-call allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc_info: object) -> None:
        return None

    def close(self) -> None:
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span/event recorder.

    ``capacity`` bounds memory on long runs: the deque drops the oldest
    events and ``n_dropped`` reports how many were lost, so a truncated
    trace is visible rather than silent.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.capacity
        )
        self.epoch_ns = profiler_clock_ns()
        self.n_total = 0
        self._ids = itertools.count(1)
        self._open: List[Span] = []  # in the order they opened
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------

    def span(self, name: str, *, cat: str = "repro",
             sim_t_s: Optional[float] = None, **args: Any) -> Span:
        if sim_t_s is not None:
            args["sim_t_s"] = sim_t_s
        return Span(self, name, cat, args)

    def event(self, name: str, *, cat: str = "repro",
              sim_t_s: Optional[float] = None, **args: Any) -> None:
        if sim_t_s is not None:
            args["sim_t_s"] = sim_t_s
        with self._lock:
            parent = self._parent(threading.get_ident())
        args["parent"] = None if parent is None else parent.args["id"]
        self._record(name, cat, "i", profiler_clock_ns(), 0, args)

    def _parent(self, thread: int) -> Optional[Span]:
        """The innermost span open on ``thread``, else on any thread."""
        for span in reversed(self._open):
            if span.thread == thread:
                return span
        return self._open[-1] if self._open else None

    def _opened(self, span: Span) -> None:
        with self._lock:
            parent = self._parent(span.thread)
            span.args["id"] = next(self._ids)
            self._open.append(span)
        span.args["parent"] = None if parent is None else parent.args["id"]
        if parent is not None:
            for key in INHERITED_ARGS:
                if key in parent.args and key not in span.args:
                    span.args[key] = parent.args[key]

    def _closed(self, span: Span) -> None:
        with self._lock:
            self._open.remove(span)

    def _record(self, name: str, cat: str, ph: str, t0_ns: int,
                dur_ns: int, args: Dict[str, Any]) -> None:
        event = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": (t0_ns - self.epoch_ns) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": TRACE_PID,
            "tid": TRACE_TID,
            "args": args,
        }
        with self._lock:
            self.n_total += 1
            self._events.append(event)

    # -- inspection / export ----------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def n_dropped(self) -> int:
        return self.n_total - len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def export(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: ``{"traceEvents": [...]}``.

        Extra top-level keys are legal in the format, so callers may
        merge this dict with metrics/timeline payloads and the result
        stays loadable in Perfetto.
        """
        return {"traceEvents": self.events()}


class NullTracer:
    """The default: records nothing, costs (almost) nothing."""

    enabled = False
    capacity = 0
    n_total = 0
    n_dropped = 0

    def span(self, name: str, *, cat: str = "repro",
             sim_t_s: Optional[float] = None, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, *, cat: str = "repro",
              sim_t_s: Optional[float] = None, **args: Any) -> None:
        return None

    def __len__(self) -> int:
        return 0

    def events(self) -> List[Dict[str, Any]]:
        return []

    def export(self) -> Dict[str, Any]:
        return {"traceEvents": []}


NULL_TRACER = NullTracer()

_CURRENT: Any = NULL_TRACER


def current() -> Any:
    """The process-wide tracer (``NULL_TRACER`` unless recording)."""
    return _CURRENT


def install(tracer: Any) -> Any:
    """Swap the process-wide tracer; returns the previous one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NULL_TRACER
    return prev
