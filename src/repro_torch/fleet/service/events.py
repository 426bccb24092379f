"""The service's event layer: typed sim-clock events and the bus.

Everything the event-driven scheduler core reacts to is an ``Event`` on
the ``EventBus`` — job arrivals, segment completions streamed back by
``NodeManager`` workers, unannounced drift shifts, node failures and
recoveries, and manager heartbeats. The bus is a deterministic priority
queue over **simulated** time: ordering is a pure function of
``(time_s, kind priority, push sequence)``, never of wall clocks or hash
order, because the service's headline contract is that draining the bus
reproduces the lockstep ``FleetScheduler.run`` schedule *bitwise*.

Batching rule: one reaction (one ``FleetScheduler.step``) consumes every
event within ``time_eps`` of the earliest pending instant — exactly the
tolerance window the lockstep driver's ingest (``finish_s <= now + eps``)
and ready-filter (``arrival_s <= now + eps``) already use, so the two
drivers agree on which events share a round.

Within one instant, kinds dispatch in a fixed order (drift before
node-down before node-up before completion before arrival before
heartbeat before tick): truth shifts land before the reaction plans, and
capacity changes land before completions/arrivals are interpreted.

``SERVICE_SCHEMA_VERSION`` pins the journal document format
(``fleet/service/store.py``); bump it on any incompatible change to the
event or snapshot encoding — ``Journal.load`` refuses mismatched files
instead of mis-replaying them.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from repro_torch.fleet.cluster import time_eps

# journal/event wire-format version (see module docstring)
SERVICE_SCHEMA_VERSION = 1

# dispatch order within one batch instant (index = priority)
EVENT_KINDS: Tuple[str, ...] = (
    "drift",  # truth shift: (app, factor) applied pool-wide
    "node-down",  # node lost (crash or declared dead on heartbeat loss)
    "node-up",  # node restored to the pool
    "completion",  # a NodeManager streamed a finished segment
    "arrival",  # a submitted job's arrival instant
    "heartbeat",  # a NodeManager's liveness beacon
    "tick",  # pure wake-up (the genesis round, demos)
)
_PRIORITY = {kind: i for i, kind in enumerate(EVENT_KINDS)}


@dataclasses.dataclass(frozen=True)
class Event:
    """One bus entry. Only the fields a kind needs are set:

    * arrival / completion: ``job_id`` (+ ``gen`` for completions — the
      per-launch generation that lets preempted segments' stale
      completions be recognized and dropped);
    * drift: ``app`` + ``factor`` (truth time multiplier);
    * node-down / node-up / heartbeat: ``node``.

    Times are simulated seconds (the ``_s`` discipline holds on the wire
    too: the JSON encoding keeps the ``time_s`` key).
    """

    time_s: float
    kind: str
    job_id: Optional[int] = None
    node: Optional[str] = None
    app: Optional[str] = None
    factor: Optional[float] = None
    gen: int = 0  # completion generation (increments per (re)launch)

    def __post_init__(self):
        if self.kind not in _PRIORITY:
            raise ValueError(
                f"unknown event kind {self.kind!r}; expected one of "
                f"{EVENT_KINDS}"
            )

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @classmethod
    def from_json(cls, payload: dict) -> "Event":
        return cls(**payload)


# -- kind constructors (the only places events are minted) ------------------


def arrival(time_s: float, job_id: int) -> Event:
    return Event(float(time_s), "arrival", job_id=int(job_id))


def completion(time_s: float, job_id: int, gen: int) -> Event:
    return Event(float(time_s), "completion", job_id=int(job_id), gen=int(gen))


def drift(time_s: float, app: str, factor: float) -> Event:
    return Event(float(time_s), "drift", app=app, factor=float(factor))


def node_down(time_s: float, node: str) -> Event:
    return Event(float(time_s), "node-down", node=node)


def node_up(time_s: float, node: str) -> Event:
    return Event(float(time_s), "node-up", node=node)


def heartbeat(time_s: float, node: str) -> Event:
    return Event(float(time_s), "heartbeat", node=node)


def tick(time_s: float) -> Event:
    return Event(float(time_s), "tick")


class EventBus:
    """Deterministic sim-clock event queue.

    A heap keyed ``(time_s, kind priority, push sequence)``: stable,
    reproducible, and independent of insertion hash order. ``pop_batch``
    is the service's clock — it returns every live event within
    ``time_eps`` of the earliest pending instant, which is exactly one
    scheduler reaction's worth of input.
    """

    def __init__(self):
        self._heap: List[Tuple[float, int, int, Event]] = []
        self._seq = 0  # FIFO tiebreak within (time, kind)

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.time_s, _PRIORITY[ev.kind], self._seq, ev))
        self._seq += 1

    def peek_time(self) -> Optional[float]:
        """Sim time of the earliest pending event (None when empty)."""
        return self._heap[0][0] if self._heap else None

    def pop_batch(
        self, is_stale: Optional[Callable[[Event], bool]] = None
    ) -> Tuple[Optional[float], List[Event]]:
        """Pop one reaction's worth of events: ``(t, batch)``.

        ``t`` is the earliest live event's time; the batch holds every
        live event with ``time_s <= t + time_eps(t)`` in dispatch order.
        ``is_stale`` (e.g. a superseded completion generation) filters
        events lazily at pop time — invalidating them in-heap would cost
        a rebuild per preemption. Returns ``(None, [])`` when drained.
        """
        if is_stale is not None:  # the batch instant must come from a
            while self._heap and is_stale(self._heap[0][-1]):  # LIVE event
                heapq.heappop(self._heap)
        if not self._heap:
            return None, []
        t0 = self._heap[0][0]
        eps = time_eps(t0)
        batch: List[Event] = []
        while self._heap and self._heap[0][0] <= t0 + eps:
            ev = heapq.heappop(self._heap)[-1]
            if is_stale is not None and is_stale(ev):
                continue
            batch.append(ev)
        return t0, batch

    def snapshot(
        self, kinds: Optional[Sequence[str]] = None
    ) -> List[dict]:
        """Pending events as JSON payloads, in heap order; ``kinds``
        restricts to the journaled (non-derivable) subset — arrivals and
        completions are reconstructed from the job queues at recovery."""
        return [
            entry[-1].to_json()
            for entry in sorted(self._heap)
            if kinds is None or entry[-1].kind in kinds
        ]

    def restore(self, payloads: Iterable[dict]) -> None:
        for p in payloads:
            self.push(Event.from_json(p))
