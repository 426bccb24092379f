"""Counters / gauges / histograms registry for the flight recorder.

Names are dot-paths with unit suffixes on quantity-bearing leaves
(``fleet.round.dur_us``, ``telemetry.observation_age_s.*``) — the same
suffix discipline repro-lint enforces on identifiers. The registry is
deliberately tiny: plain Python accumulation, no locks (the stack is
single-threaded per process), deterministic snapshots (sorted names,
pure-Python numbers) so two identical runs produce identical rollups.

The process-wide default is :data:`NULL_METRICS`, whose instruments
are shared no-op singletons — uninstrumented code pays one dict-free
call per hook and allocates nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Counter:
    """Monotonic count of occurrences."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming summary: count / total / min / max (no buckets —
    the trace has the raw samples when distribution shape matters)."""

    __slots__ = ("name", "count", "total", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total": self.total,
            "mean": mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }


class _NullCounter:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        return None


class _NullGauge:
    __slots__ = ()

    def set(self, value: float) -> None:
        return None


class _NullHistogram:
    __slots__ = ()

    def observe(self, value: float) -> None:
        return None


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name → instrument store with deterministic snapshots."""

    enabled = True

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Sorted, plain-Python rollup — identical runs snapshot equal."""
        return {
            "counters": {
                name: self._counters[name].value
                for name in sorted(self._counters)
            },
            "gauges": {
                name: self._gauges[name].value
                for name in sorted(self._gauges)
            },
            "histograms": {
                name: self._histograms[name].summary()
                for name in sorted(self._histograms)
            },
        }


class NullMetrics:
    """The default: every instrument is a shared no-op singleton."""

    enabled = False

    def counter(self, name: str) -> _NullCounter:
        return _NULL_COUNTER

    def gauge(self, name: str) -> _NullGauge:
        return _NULL_GAUGE

    def histogram(self, name: str) -> _NullHistogram:
        return _NULL_HISTOGRAM

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()

_CURRENT: Any = NULL_METRICS


def current() -> Any:
    """The process-wide registry (``NULL_METRICS`` unless recording)."""
    return _CURRENT


def install(registry: Any) -> Any:
    """Swap the process-wide registry; returns the previous one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = registry if registry is not None else NULL_METRICS
    return prev


def diff(before: Optional[Dict[str, Any]],
         after: Dict[str, Any]) -> Dict[str, Any]:
    """What happened between two snapshots.

    Counters: deltas (zero deltas dropped). Gauges: the ``after``
    values. Histograms: count/total deltas with the window mean.
    Used by ``run_engine_fleet`` to attribute registry activity to one
    scenario when several run in the same process.
    """
    before = before or {"counters": {}, "gauges": {}, "histograms": {}}
    counters = {}
    for name, value in after.get("counters", {}).items():
        delta = value - before.get("counters", {}).get(name, 0)
        if delta:
            counters[name] = delta
    histograms = {}
    for name, summ in after.get("histograms", {}).items():
        prev = before.get("histograms", {}).get(
            name, {"count": 0, "total": 0.0}
        )
        n = summ["count"] - prev["count"]
        if n <= 0:
            continue
        total = summ["total"] - prev["total"]
        histograms[name] = {
            "count": n, "total": total, "mean": total / n,
        }
    return {
        "counters": counters,
        "gauges": dict(after.get("gauges", {})),
        "histograms": histograms,
    }
