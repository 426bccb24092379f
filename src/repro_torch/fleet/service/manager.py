"""Worker-side node managers: claim placements, stream results back.

One ``NodeManager`` per ``FleetNode`` (the QCFractal queue-manager shape:
the planner never touches a node directly — a worker claims the
placement, executes it, and streams the completion back as a bus event).
In this simulated fleet the "execution" is the node model's deterministic
run, so the manager's real job is bookkeeping the service needs:

* **claims** — every launch routes through ``execute`` (the scheduler's
  ``_executor`` seam), so a down node can refuse work at the claim site,
  not just at capacity-query time;
* **completion streaming** — each finished segment becomes a
  ``completion`` event carrying the launch *generation*, so a later
  preemption can invalidate the stale event instead of double-finishing
  the job;
* **heartbeats** — an opt-in liveness chain on the sim clock; a manager
  that stops beating (the injected heartbeat-loss fault) is declared
  down by the service after ``timeout_factor × period`` of silence.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.fleet.cluster import FleetNode, time_eps
from repro_torch.fleet.service import events as ev


class NodeManager:
    """The worker loop for one node, flattened onto the sim clock."""

    def __init__(self, node: FleetNode, bus):
        self.node = node
        self.bus = bus
        self.claims = 0
        self.completions_streamed = 0
        self.last_heartbeat_s = 0.0
        self.heartbeat_period_s: Optional[float] = None
        # fault injection: the manager goes silent at this sim time (its
        # node keeps running — the SERVICE must notice the missing beats)
        self.silence_after_s: Optional[float] = None

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def available(self) -> bool:
        return self.node.available

    # -- claiming + execution ---------------------------------------------

    def execute(self, scheduler, job, frequency_ghz: float, cores: int):
        """Claim one placement and run it (the ``_executor`` seam)."""
        if not self.node.available:
            raise RuntimeError(
                f"manager {self.name}: node is down, cannot claim work"
            )
        self.claims += 1
        return scheduler._run_on(self.node, job, frequency_ghz, cores)

    def stream_completion(self, completed, gen: int) -> bool:
        """Publish a launched segment's completion onto the bus.

        Returns False (no event) for a segment finishing within the
        launch instant's tolerance — ``NodePool.next_completion`` skips
        those too, and the very round that launched them ingests them, so
        an event would only schedule a spurious extra reaction.
        """
        start_s = completed.placement.start_s
        if completed.finish_s <= start_s + time_eps(start_s):
            return False
        self.bus.push(
            ev.completion(completed.finish_s, completed.placement.job.job_id, gen)
        )
        self.completions_streamed += 1
        return True

    # -- liveness -----------------------------------------------------------

    def start_heartbeat(self, period_s: float, now_s: float = 0.0) -> None:
        self.heartbeat_period_s = float(period_s)
        self.last_heartbeat_s = float(now_s)
        self._push_next_beat(now_s)

    def beat(self, now_s: float, *, more_work: bool) -> None:
        """Process this manager's own beat: record liveness, chain the
        next one while the fleet still has work (the chain ends itself
        when the queues drain, so a finished service goes quiet)."""
        self.last_heartbeat_s = float(now_s)
        if more_work:
            self._push_next_beat(now_s)

    def _push_next_beat(self, now_s: float) -> None:
        if self.heartbeat_period_s is None:
            return
        nxt = now_s + self.heartbeat_period_s
        # the injected fault: a silenced manager stops publishing beats
        if self.silence_after_s is not None and nxt >= self.silence_after_s:
            return
        self.bus.push(ev.heartbeat(nxt, self.name))

    # -- availability --------------------------------------------------------

    def mark_down(self) -> None:
        self.node.available = False

    def mark_up(self, now_s: float) -> None:
        self.node.available = True
        # a restored node is live *now*; restart its beat chain
        self.last_heartbeat_s = float(now_s)
        self._push_next_beat(now_s)
