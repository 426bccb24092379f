"""The event-driven scheduler core: the service that subsumes ``run()``.

``SchedulerService`` wraps a ``FleetScheduler`` and pumps its ``step()``
reaction from an ``EventBus`` instead of the lockstep loop:

    submit → arrival events     ┐
    NodeManager completions     ├→ EventBus.pop_batch → apply batch
    drift / node-down / node-up │      → FleetScheduler.step(t)
    manager heartbeats          ┘      → Journal.commit(snapshot)

One reaction still issues ONE batched engine pass (``step`` is unchanged
— ``engine.py`` owns the argmin, on the planning kernels for a CUDA
engine); the service adds what a lockstep sim cannot have:

* **durable state** — after every batch the full snapshot (job queues,
  reservation ledger incl. tentative holds, node RNGs, believed
  surfaces, telemetry windows) commits atomically to the journal;
* **crash recovery** — ``SchedulerService.resume`` rebuilds a fresh
  scheduler from the journal and replays to a schedule bitwise-identical
  to the uninterrupted run (``tests/test_torch_service_recovery.py`` kills at
  every batch index and asserts exactly that);
* **fault tolerance** — node-down events (explicit or declared after
  heartbeat loss) kill the node's in-flight segments, charge the burned
  joules to the jobs' carried priors (the ledger stays honest), requeue
  the jobs, and the same reaction replans them on surviving nodes.

Determinism rules the design: the bus orders by ``(sim time, kind,
sequence)``, batches group within ``time_eps`` (the lockstep driver's
exact tolerance), and nothing on the service path reads a wall clock —
``tests/test_torch_service.py`` checks that statically.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.fleet.cluster import time_eps
from repro_torch.fleet.scheduler import CompletedJob, FleetScheduler, Job
from repro_torch.fleet.service import events as ev
from repro_torch.fleet.service.events import SERVICE_SCHEMA_VERSION, Event, EventBus
from repro_torch.fleet.service.manager import NodeManager
from repro_torch.fleet.service import store
from repro_torch.fleet.service.store import JobStore, Journal, LedgerStore
from repro_torch.fleet.telemetry import PreemptionRecord

# journaled event kinds: externally-injected state the queues cannot
# re-derive. Arrivals/completions are reconstructed from the job queues.
_JOURNALED_KINDS = ("drift", "node-down", "node-up", "heartbeat", "tick")


class ServiceKilled(RuntimeError):
    """The simulated crash (``--kill-at`` / ``kill_after_batches``): the
    process "dies" before processing the next event batch. The journal on
    disk holds the last committed snapshot — ``SchedulerService.resume``
    continues from it."""

    def __init__(
        self,
        message: str,
        *,
        journal_path: Optional[str] = None,
        time_s: Optional[float] = None,
        n_batches: int = 0,
    ):
        super().__init__(message)
        self.journal_path = journal_path
        self.time_s = time_s
        self.n_batches = n_batches


class SchedulerService:
    """Event-driven scheduler service over one ``FleetScheduler``.

    Args:
        scheduler: the reactor. The service attaches itself to the
            scheduler's service seams (launch/preempt observers, the
            executor) — one service per scheduler.
        journal: a ``Journal``, a path string, or None (no durability).
        config: opaque run-configuration blob stored in every snapshot so
            ``--resume`` can rebuild the pool/engine/policies (the
            snapshot holds *state*; the config holds how to re-create the
            objects the state loads into).
        heartbeat_period_s: when set, every NodeManager publishes
            liveness beats on the sim clock and the service declares a
            manager dead (node-down) after ``heartbeat_timeout_factor ×
            period`` of silence. Off by default: beat events would add
            reaction instants the lockstep driver does not have, and
            bitwise parity with it is the default contract.
        kill_at_s / kill_after_batches: fault-injection kill switches —
            raise ``ServiceKilled`` before processing the first batch
            past the sim time / at the batch index.
    """

    def __init__(
        self,
        scheduler: FleetScheduler,
        *,
        journal=None,
        config: Optional[dict] = None,
        heartbeat_period_s: Optional[float] = None,
        heartbeat_timeout_factor: float = 2.5,
        kill_at_s: Optional[float] = None,
        kill_after_batches: Optional[int] = None,
    ):
        self.scheduler = scheduler
        self.pool = scheduler.pool
        self.bus = EventBus()
        self.journal = Journal(journal) if isinstance(journal, str) else journal
        self.config = dict(config or {})
        self.heartbeat_period_s = heartbeat_period_s
        self.heartbeat_timeout_factor = float(heartbeat_timeout_factor)
        self.kill_at_s = kill_at_s
        self.kill_after_batches = kill_after_batches
        self.managers: Dict[str, NodeManager] = {
            node.name: NodeManager(node, self.bus) for node in self.pool
        }
        self.n_batches = 0
        self.recovered = False
        self._now_s = 0.0  # sim time of the last processed batch
        # completion-generation bookkeeping: _gen counts launches per
        # job; _live maps job -> the generation whose completion event is
        # still valid. A preemption (or node kill) drops the entry, so
        # the superseded event is recognized as stale at pop time.
        self._gen: Dict[int, int] = {}
        self._live: Dict[int, int] = {}
        scheduler._launch_observers.append(self._on_launch)
        scheduler._preempt_observers.append(self._on_preempt)
        scheduler._executor = self._execute

    # -- scheduler seams -----------------------------------------------------

    def _execute(self, node, job, frequency_ghz: float, cores: int):
        return self.managers[node.name].execute(
            self.scheduler, job, frequency_ghz, cores
        )

    def _on_launch(self, completed: CompletedJob) -> None:
        jid = completed.placement.job.job_id
        gen = self._gen.get(jid, -1) + 1
        self._gen[jid] = gen
        manager = self.managers[completed.placement.node]
        if manager.stream_completion(completed, gen):
            self._live[jid] = gen
        else:
            # eps-short segment: ingested by the launching round itself
            self._live.pop(jid, None)

    def _on_preempt(self, completed: CompletedJob, now_s: float) -> None:
        self._live.pop(completed.placement.job.job_id, None)

    def _is_stale(self, event: Event) -> bool:
        return (
            event.kind == "completion"
            and self._live.get(event.job_id) != event.gen
        )

    # -- intake --------------------------------------------------------------

    def submit(self, job: Job) -> None:
        """Re-entrant job intake: queue the job, schedule its arrival."""
        if self.journal is not None and job.terms is not None:
            # reject unjournalable believed surfaces at intake, not at the
            # first commit (store's fixed wire schema covers exactly
            # TermsFamily-over-RooflineTerms — the model-zoo intake)
            store._terms_to_json(job)
        sched = self.scheduler
        sched._pending.append(job)
        # stable sort on the lockstep driver's exact key: a batch of
        # up-front submissions lands in the identical planning order
        sched._pending.sort(key=lambda j: (j.arrival_s, j.job_id))
        self.bus.push(ev.arrival(max(job.arrival_s, 0.0), job.job_id))

    def schedule_drift(
        self, drift_events: Sequence[Tuple[float, str, float]]
    ) -> None:
        """Queue (sim time, app, factor) truth shifts as drift events."""
        for t, app, factor in sorted(drift_events):
            self.bus.push(ev.drift(max(float(t), 0.0), app, float(factor)))

    def inject(self, event: Event) -> None:
        """Push an externally-minted event (fault schedules, demos)."""
        self.bus.push(event)

    # -- the service loop ----------------------------------------------------

    def run(
        self,
        jobs: Sequence[Job] = (),
        *,
        drift_events: Sequence[Tuple[float, str, float]] = (),
        max_batches: int = 100_000,
    ) -> List[CompletedJob]:
        """Event-driven analogue of ``FleetScheduler.run``: submit the
        trace, seed the bus, drain it to completion. Returns the
        completed ledger (bitwise-identical to the lockstep driver's)."""
        for job in jobs:
            self.submit(job)
        self.schedule_drift(drift_events)
        if self.heartbeat_period_s is not None:
            for manager in self.managers.values():
                manager.start_heartbeat(self.heartbeat_period_s, 0.0)
        # the genesis tick: the lockstep driver always rounds at t=0
        self.bus.push(ev.tick(0.0))
        self._commit(0.0)  # durable before the first batch ever runs
        return self.drain(max_batches=max_batches)

    def drain(self, *, max_batches: int = 100_000) -> List[CompletedJob]:
        """Pump reaction rounds until the queues empty (the service's
        main loop; also the continuation entered after ``resume``)."""
        sched = self.scheduler
        for _ in range(max_batches):
            if not (sched._pending or sched._finish_queue):
                break
            t, batch = self.bus.pop_batch(self._is_stale)
            if t is None:
                break  # unplaceable remainder: nothing left to wake us
            self._maybe_die(t)
            self._now_s = t
            with obs.span(
                "service.batch", cat="service", sim_t_s=t, n_events=len(batch)
            ):
                self._apply(t, batch)
                sched.step(t)
            self.n_batches += 1
            obs.counter("service.batches").inc()
            self._commit(t)
        sched.pool.release_tentative()  # holds are plans; the run is over
        sched._ingest(float("inf"))
        self._commit(self._now_s)
        return sched.completed

    def _maybe_die(self, t: float) -> None:
        kill_time = (
            self.kill_at_s is not None
            and t > self.kill_at_s + time_eps(self.kill_at_s)
        )
        kill_count = (
            self.kill_after_batches is not None
            and self.n_batches >= self.kill_after_batches
        )
        if kill_time or kill_count:
            path = self.journal.path if self.journal is not None else None
            raise ServiceKilled(
                f"service killed before batch {self.n_batches} "
                f"(sim t={t:g}s); journal: {path}",
                journal_path=path,
                time_s=t,
                n_batches=self.n_batches,
            )

    def _apply(self, now: float, batch: Sequence[Event]) -> None:
        """Apply one batch's state changes before the reaction plans.

        Arrival, completion and tick events are pure wake-ups — the
        reaction's own ingest/ready filters do that work, exactly as in
        lockstep mode. Drift, availability and heartbeat events carry
        state the lockstep driver applied out-of-band (or not at all).
        """
        obs.counter("service.events_dispatched").inc(len(batch))
        sched = self.scheduler
        for event in batch:
            if event.kind == "drift":
                self.pool.apply_drift(event.app, event.factor)
                obs.event(
                    "service.drift", cat="service", sim_t_s=now,
                    app=event.app, factor=event.factor,
                )
            elif event.kind == "node-down":
                self._node_down(now, event.node)
            elif event.kind == "node-up":
                self._node_up(now, event.node)
            elif event.kind == "heartbeat":
                self.managers[event.node].beat(
                    now,
                    more_work=bool(sched._pending or sched._finish_queue),
                )
        self._check_heartbeats(now)

    def _check_heartbeats(self, now: float) -> None:
        """Declare managers dead after ``timeout_factor × period`` of
        silence — the node keeps physically running, but a fleet that
        cannot hear a manager cannot trust its placements."""
        if self.heartbeat_period_s is None:
            return
        timeout_s = self.heartbeat_timeout_factor * self.heartbeat_period_s
        for manager in self.managers.values():
            silent_s = now - manager.last_heartbeat_s
            if manager.available and silent_s > timeout_s + time_eps(now):
                obs.event(
                    "service.heartbeat_lost", cat="service", sim_t_s=now,
                    node=manager.name, silent_s=silent_s,
                )
                self._node_down(now, manager.name)

    # -- node failure / recovery --------------------------------------------

    def _node_down(self, now: float, name: str) -> None:
        """Take one node out of the fleet: zero its capacity, kill its
        in-flight segments (burned joules carried onto the jobs — the
        ledger stays honest), requeue the jobs, drop its holds. The same
        reaction replans the requeued jobs on the surviving nodes."""
        manager = self.managers[name]
        if not manager.available:
            return
        manager.mark_down()
        sched = self.scheduler
        eps = time_eps(now)
        killed = [
            c
            for c in sched._finish_queue
            if c.placement.node == name and c.finish_s > now + eps
        ]
        for c in killed:
            job = c.placement.job
            elapsed = max(now - c.placement.start_s, 0.0)
            done_frac = min(elapsed / max(c.result.time_s, 1e-12), 1.0)
            burned_j = c.result.energy_j * done_frac
            manager.node.truncate_reservation(job.job_id, now)
            sched._finish_queue.remove(c)
            self._live.pop(job.job_id, None)
            # carry everything the dead segment cost (its own burn plus
            # whatever it was already carrying) onto the job's relaunch
            pe, pt, pm, pr = sched._carry.get(job.job_id, (0.0, 0.0, 0, 0))
            sched._carry[job.job_id] = (
                pe + c.prior_energy_j + burned_j,
                pt + c.prior_time_s + elapsed,
                pm + c.migrations,
                pr + c.restarts + 1,
            )
            sched.telemetry.record_preemption(
                PreemptionRecord(
                    time_s=now,
                    family=(job.app, job.input_size),
                    job_id=job.job_id,
                    from_node=name,
                    to_node="",  # no destination yet: the replan picks it
                    burned_j=burned_j,
                    migration_cost_j=0.0,  # a crash is not a checkpoint
                    projected_saving_j=0.0,
                    start_s=c.placement.start_s,
                    cores=c.placement.cores,
                )
            )
            sched._pending.append(job)
            obs.counter("service.requeues").inc()
        if killed:
            sched._pending.sort(key=lambda j: (j.arrival_s, j.job_id))
        manager.node.release_tentative()
        obs.event(
            "service.node_down", cat="service", sim_t_s=now,
            node=name, killed_jobs=len(killed),
        )

    def _node_up(self, now: float, name: str) -> None:
        manager = self.managers[name]
        if manager.available:
            return
        manager.mark_up(now)
        obs.event("service.node_up", cat="service", sim_t_s=now, node=name)

    # -- durability ----------------------------------------------------------

    def snapshot(self, now_s: float) -> dict:
        """The full durable state as one JSON-serializable document (the
        journal schema; see docs/architecture.md)."""
        sched = self.scheduler
        return {
            "schema_version": SERVICE_SCHEMA_VERSION,
            "now_s": now_s,
            "n_batches": self.n_batches,
            "config": self.config,
            "events": self.bus.snapshot(kinds=_JOURNALED_KINDS),
            "gens": [[jid, g] for jid, g in sorted(self._gen.items())],
            "managers": [
                {
                    "name": m.name,
                    "claims": m.claims,
                    "completions_streamed": m.completions_streamed,
                    "last_heartbeat_s": m.last_heartbeat_s,
                    "silence_after_s": m.silence_after_s,
                }
                for m in self.managers.values()
            ],
            "jobs": JobStore.snapshot(sched),
            "ledger": LedgerStore.snapshot(sched),
        }

    def _commit(self, now_s: float) -> None:
        if self.journal is None:
            return
        with obs.span("service.journal.commit", cat="service", sim_t_s=now_s):
            self.journal.commit(self.snapshot(now_s))
        obs.counter("service.journal_commits").inc()

    def restore(self, payload: dict) -> "SchedulerService":
        """Load a journal snapshot into this service (which must wrap a
        FRESH scheduler built with the killed run's seeds/policies).

        Derived events are reconstructed from the restored queues: future
        arrivals from ``_pending``, in-flight completions (at their
        journaled generations) from ``_finish_queue`` — truncated
        reservations of crash-killed segments stay truncated because the
        ledger is restored verbatim, and tentative holds come back as
        holds for the next reaction to re-confirm or release.
        """
        with obs.span("service.recover", cat="service"):
            sched = self.scheduler
            now_s = float(payload["now_s"])
            self._now_s = now_s
            self.n_batches = int(payload["n_batches"])
            self.config = dict(payload.get("config", {}))
            JobStore.restore(sched, payload["jobs"])
            LedgerStore.restore(sched, payload["ledger"])
            self._gen = {int(j): int(g) for j, g in payload["gens"]}
            for p in payload["managers"]:
                manager = self.managers[p["name"]]
                manager.claims = int(p["claims"])
                manager.completions_streamed = int(p["completions_streamed"])
                manager.last_heartbeat_s = float(p["last_heartbeat_s"])
                manager.silence_after_s = p["silence_after_s"]
                manager.heartbeat_period_s = self.heartbeat_period_s
            self.bus.restore(payload["events"])
            eps = time_eps(now_s)
            self._live = {}
            for job in sched._pending:
                if job.arrival_s > now_s + eps:
                    self.bus.push(ev.arrival(job.arrival_s, job.job_id))
            for c in sched._finish_queue:
                jid = c.placement.job.job_id
                if c.finish_s > now_s + eps:
                    gen = self._gen.get(jid, 0)
                    self.bus.push(ev.completion(c.finish_s, jid, gen))
                    self._live[jid] = gen
            self.recovered = True
        obs.counter("service.recoveries").inc()
        return self

    @classmethod
    def resume(
        cls, path: str, scheduler: FleetScheduler, **kwargs
    ) -> "SchedulerService":
        """Restart from a journal file: validate the schema, wrap the
        fresh scheduler, restore. Continue with ``drain()``."""
        payload = Journal.load(path)
        service = cls(scheduler, journal=path, **kwargs)
        return service.restore(payload)
