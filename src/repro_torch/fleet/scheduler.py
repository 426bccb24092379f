"""Energy-optimal fleet scheduling: one batched argmin per round.

The scheduling round (the loop the whole subsystem exists to run):

    plan_many  →  place  →  run  →  telemetry  →  re-fit
       │            │        │         │            │
       │            │        │         │            └ stale families only,
       │            │        │         │              ONE ``svr.fit_many``
       │            │        │         └ measured RunResults vs plan
       │            │        └ simulated nodes, reservation ledger
       │            └ energy-aware bin-pack: plan energy × node skew,
       │              ``pareto()`` fallback when the optimum misses a
       │              deadline
       └ EVERY pending job in ONE ``PlanningEngine.plan_many`` call

Per round the scheduler builds one ``Workload`` per pending job — the
family's hashable ``AppTerms`` as the characterization key, plus
``Constraints(max_cores=free cores, max_time_s=deadline slack)`` — and
batch-plans them all in a single ``plan_many`` call: one ``svr.fit_many``
over the cache-missing families, one batched grid prediction, one jitted
objective tensor. Placement projects the reference-node plan onto each
node via the admin-known spec skews and picks the feasible node with the
lowest expected energy. When the energy-optimal configuration cannot meet
the job's deadline on any node with capacity, the scheduler walks the
job's energy/time ``pareto()`` frontier from the cheapest point toward the
fastest and takes the first (point, node) pair that fits — spending the
fewest extra joules that buy deadline feasibility.

The sensing half closes the loop: completed runs stream into the
``TelemetryHub``; families whose windowed relative time-model error
crosses the drift threshold are re-characterized *from telemetry* — the
believed surface rescaled by the measured drift ratio and anchored by the
windowed real observations, so the refit costs no extra measurement runs
— with ALL stale families fitted in ONE ``svr.fit_many`` batch and the
fresh models installed into the engine cache via
``PlanningEngine.install_fit`` under the same family keys.

Two opt-in upgrades close the remaining gaps:

* ``negotiator=Negotiator(...)`` replaces per-job greedy placement with
  the fleet-wide pareto negotiation of ``fleet/negotiate.py`` (ONE
  batched ``pareto_many`` per round, joint assignment never lexically
  worse than the cheapest-first seed);
* ``migration=MigrationPolicy(...)`` adds preemptive rebalancing: a
  material drift re-fit re-plans the family's in-flight jobs and moves
  them when the believed remaining-energy saving clears the migration
  cost — with the abandoned joules honestly charged.

Two drivers pump the round. ``run()`` is the lockstep simulation loop
(rounds fire at the next arrival/completion/drift time). The
event-driven service core (``repro_torch.fleet.service``) pumps the SAME
``step()`` as a reaction to event batches, adds durable snapshot/journal
state, node failures and crash recovery — and reproduces the lockstep
schedule bitwise (``tests/test_service.py``). ``step()`` is the shared
reaction; ``run()`` doubles as the parity oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import svr as svr_mod
from repro_torch.core import tpu_power
from repro_torch.core.engine import (
    CHIP_GRID,
    ENGINE_FIT_KW,
    TIME_FLOOR,
    Constraints,
    EnergyPlan,
    PlanningEngine,
    Workload,
    cpu_space,
    tpu_space,
)
from repro_torch.core.node_sim import CORES_PER_SOCKET, RunResult
from repro_torch.core.power import fit_power_model
from repro_torch.device import DeviceLike
from repro_torch.fleet.cluster import (
    AppTerms,
    CapacityProfile,
    FleetNode,
    NodePool,
    family_key,
    project_point,
    time_eps,
)
from repro_torch.fleet.negotiate import Negotiator
from repro_torch.fleet.telemetry import (
    Family,
    Observation,
    PreemptionRecord,
    TelemetryHub,
    TentativeRecord,
)


@dataclasses.dataclass(frozen=True)
class Job:
    """One queued workload: (app, input) plus its service-level deadline.

    ``terms`` is the artifact-intake hook: when set (a frozen,
    engine-compatible believed surface such as ``cluster.TermsFamily``),
    the scheduler plans and runs the job on that surface instead of the
    node profile table — ``workloads_from_artifacts`` records enter the
    fleet queue this way.
    """

    job_id: int
    app: str
    input_size: float
    deadline_s: float  # absolute sim time by which the job must finish
    arrival_s: float = 0.0
    terms: Optional[object] = None  # explicit believed surface (artifacts)
    # which ConfigSpace the job plans in: it only ever places on nodes of
    # the same device family ("cpu" = (f, cores), "tpu" = (f, chips, pods))
    device: str = "cpu"


@dataclasses.dataclass
class Placement:
    """One placed job: the chosen (node, f, p) and its projected cost."""

    job: Job
    node: str
    frequency_ghz: float
    cores: int
    start_s: float
    predicted_time_s: float  # node-projected (reference time × speed skew)
    predicted_energy_j: float  # node-projected plan energy
    pareto_fallback: bool = False  # True: deadline bought on the frontier
    negotiated: bool = False  # True: chosen by the round's Negotiator
    migrated_from: Optional[str] = None  # node the job was preempted off


@dataclasses.dataclass
class CompletedJob:
    placement: Placement
    result: RunResult
    finish_s: float
    met_deadline: bool
    # honest preemption accounting: joules already burned on abandoned
    # segments plus the charged migration cost, the wall time those
    # segments took, and how often the job moved
    prior_energy_j: float = 0.0
    prior_time_s: float = 0.0
    migrations: int = 0
    # how often a node failure killed a segment and the job was requeued
    # (service mode) — crash restarts do not consume the migration budget
    restarts: int = 0

    @property
    def total_energy_j(self) -> float:
        """Everything the fleet actually spent on this job (J): the final
        segment plus every preempted partial segment and migration charge."""
        return self.result.energy_j + self.prior_energy_j

    @property
    def total_time_s(self) -> float:
        """The job's whole wall time (s), abandoned segments included —
        the time axis must stay consistent with ``total_energy_j`` or a
        migrated job's implied power would read ~segments× too high."""
        return self.result.time_s + self.prior_time_s


@dataclasses.dataclass
class RoundLog:
    """What one scheduling round did (the auditable invariant record)."""

    now: float
    n_pending: int
    planned: bool  # True: this round issued its (single) plan_many call
    n_placed: int = 0
    refit_families: List[Family] = dataclasses.field(default_factory=list)
    negotiated: bool = False  # True: placements came from the Negotiator
    n_moves: int = 0  # negotiation single reassignments
    n_exchanges: int = 0  # negotiation multi-job slack exchanges
    n_migrated: int = 0  # in-flight jobs preempted + relaunched post-refit
    n_future: int = 0  # known-future arrivals planned by the lookahead pass
    n_tentative: int = 0  # tentative reservations placed this round


@dataclasses.dataclass(frozen=True)
class LookaheadPolicy:
    """Horizon-aware planning: how far ahead the round looks.

    Every planning round also plans the known FUTURE arrivals inside
    ``horizon_s`` (in the same single batched ``pareto_many`` pass, their
    slack measured from their arrival via ``Workload.earliest_start_s``)
    and places them as *tentative* reservations — capacity holds that
    keep the current round's ready jobs from stranding the nodes the
    near-future burst will need. Each round releases the previous round's
    holds and re-plans them with fresh information; a hold converts to a
    real (confirmed) reservation when its job launches.
    """

    horizon_s: float = 600.0  # how far ahead arrivals are planned, seconds


@dataclasses.dataclass(frozen=True)
class MigrationPolicy:
    """When a drift-triggered re-fit justifies preempting a running job.

    A migration is charged ``cost_j`` joules (checkpoint + transfer +
    restart) on top of the energy already burned on the abandoned segment,
    so it only pays when the believed remaining-energy saving clears the
    cost with ``min_saving_frac`` to spare.
    """

    cost_j: float = 2_000.0  # joules charged per preemption
    min_drift: float = 0.10  # |refit scale ratio - 1| that triggers a re-plan
    min_remaining_frac: float = 0.25  # don't move nearly-finished jobs
    min_saving_frac: float = 0.05  # saving must also clear this × remaining
    max_migrations_per_job: int = 1


def apply_due_events(
    pool: NodePool,
    events: Sequence[Tuple[float, str, float]],
    ei: int,
    now: float,
) -> int:
    """Apply every (time, app, factor) drift event due by ``now`` to the
    pool's truth; returns the index of the first still-future event. Shared
    by the engine scheduler and the governor-FIFO baseline so both
    scenarios shift at identical sim times."""
    while ei < len(events) and events[ei][0] <= now + time_eps(now):
        _, app, factor = events[ei]
        pool.apply_drift(app, factor)
        ei += 1
    return ei


def next_event_time(
    pool: NodePool,
    pending: Sequence[Job],
    events: Sequence[Tuple[float, str, float]],
    ei: int,
    now: float,
) -> Optional[float]:
    """The next sim time anything can change: a job completion, a future
    arrival, or a scheduled drift event. ``None`` means nothing is left to
    wait for (an unplaceable remainder). One definition — the engine and
    baseline simulation loops must advance their clocks identically. All
    comparisons use the shared relative tolerance ``cluster.time_eps``, so
    the advance survives arbitrarily large sim clocks (an absolute epsilon
    underflows the float64 ulp past t ~ 1e6 s)."""
    eps = time_eps(now)
    nexts = []
    completion = pool.next_completion(now)
    if completion is not None:
        nexts.append(completion)
    arrivals = [j.arrival_s for j in pending if j.arrival_s > now + eps]
    if arrivals:
        nexts.append(min(arrivals))
    if ei < len(events):
        nexts.append(max(events[ei][0], now + eps))
    return min(nexts) if nexts else None


def fleet_engine(
    pool: NodePool,
    *,
    freqs: Optional[Sequence[float]] = None,
    cores: Optional[Sequence[int]] = None,
    noise: float = 0.01,
    seed: int = 0,
    objective: str = "energy",
    power_model=None,
    device: DeviceLike = None,
) -> PlanningEngine:
    """A ``PlanningEngine`` on the fleet's reference-node scale.

    The grid is (reference frequency table × 1..max cores in the pool);
    the power model is fitted from the reference node's §3.3 stress sweep
    (or injected). Node heterogeneity enters at *placement* via the spec
    skews, not here — one engine, one argmin, N nodes. ``device`` is the
    engine's torch device (``None``: the CUDA device, raises without one).
    """
    ref = pool.reference
    freqs = tuple(ref.spec.freq_table) if freqs is None else tuple(freqs)
    if cores is None:
        # only the reference device's nodes bound the grid (identity on a
        # homogeneous pool; a mixed pool's TPU chip counts stay out)
        peers = pool.nodes_for(ref.spec.device)
        cores = tuple(range(1, max(n.spec.max_cores for n in peers) + 1))
    else:
        cores = tuple(int(c) for c in cores)
    if power_model is None:
        power_model = fit_power_model(*ref.stress_grid(freqs, cores))
    return PlanningEngine(
        power_model,
        space=cpu_space(
            freq_grid=freqs,
            chip_grid=cores,
            cores_per_socket=CORES_PER_SOCKET,
        ),
        noise=noise,
        seed=seed,
        objective=objective,
        on_infeasible="fastest",
        device=device,
    )


def tpu_fleet_engine(
    pool: NodePool,
    *,
    freqs: Optional[Sequence[float]] = None,
    chips: Optional[Sequence[int]] = None,
    noise: float = 0.01,
    seed: int = 0,
    objective: str = "energy",
    power_model=None,
    device: DeviceLike = None,
) -> PlanningEngine:
    """The TPU-family sibling of ``fleet_engine``: a ``PlanningEngine``
    over the (f_ghz, chips, pods) ``ConfigSpace`` of the pool's TPU
    slices. The power surface is the paper's Eq. 7 refit for v5e — fitted
    by the same ``fit_power_model`` OLS from ``tpu_power.FleetTelemetry``
    stress samples (the fleet's IPMI stand-in), never the truth constants.
    """
    ref = pool.reference_for("tpu")
    freqs = tuple(ref.spec.freq_table) if freqs is None else tuple(freqs)
    if chips is None:
        biggest = max(n.spec.max_cores for n in pool.nodes_for("tpu"))
        chips = tuple(c for c in CHIP_GRID if c <= biggest)
    else:
        chips = tuple(int(c) for c in chips)
    if power_model is None:
        power_model = tpu_power.fit_fleet_power(
            tpu_power.FleetTelemetry(seed=seed)
        )
    return PlanningEngine(
        power_model,
        space=tpu_space(
            freq_grid=freqs,
            chip_grid=chips,
            chips_per_pod=ref.spec.cores_per_socket,
        ),
        noise=noise,
        seed=seed,
        objective=objective,
        on_infeasible="fastest",
        device=device,
    )


class FleetScheduler:
    """Round-based energy-optimal scheduler over a heterogeneous pool."""

    def __init__(
        self,
        pool: NodePool,
        engine: PlanningEngine,
        telemetry: Optional[TelemetryHub] = None,
        *,
        char_freqs: Optional[Sequence[float]] = None,
        char_cores: Optional[Sequence[int]] = None,
        negotiator: Optional[Negotiator] = None,
        migration: Optional[MigrationPolicy] = None,
        lookahead: Optional[LookaheadPolicy] = None,
    ):
        """Args:
            pool / engine / telemetry: the fleet, its planning engine(s)
                and the observation hub. ``engine`` is either ONE shared
                ``PlanningEngine`` (homogeneous pool, the default path) or
                a ``{device: PlanningEngine}`` dict (mixed pool): each
                job then plans in its own device's ``ConfigSpace`` and
                only places on device-compatible nodes; batched engine
                passes group by device (one ``plan_many``/``pareto_many``
                per device family per round).
            char_freqs / char_cores: the re-characterization refit grid
                (GHz / cores); defaults to the engine's planning grid. In
                mixed mode the explicit values apply to the reference
                device's families; other devices refit on their own
                engine's planning grid.
            negotiator: when set, rounds place via fleet-wide pareto
                negotiation (``negotiate.Negotiator``) instead of the
                per-job cheapest-first fallback.
            migration: when set, a material drift re-fit triggers the
                preemptive-rebalancing pass over in-flight jobs.
            lookahead: when set, every planning round also plans the
                known future arrivals inside ``lookahead.horizon_s`` in
                the same batched engine pass and holds capacity for them
                with tentative reservations (horizon-aware mode).
        """
        self.pool = pool
        if isinstance(engine, dict):
            # mixed pool: one engine per device family; ``self.engine``
            # stays the reference device's engine so single-engine
            # consumers (service store, summaries) keep working
            self.engines: Optional[Dict[str, PlanningEngine]] = dict(engine)
            self.engine = self.engines[pool.reference.spec.device]
            # the drift refit below is one ``fit_many`` batch on one device
            if len({eng.device for eng in self.engines.values()}) > 1:
                raise ValueError(
                    "a mixed pool's engines must share one torch device"
                )
        else:
            self.engines = None
            self.engine = engine
        self.telemetry = telemetry if telemetry is not None else TelemetryHub()
        # re-characterization refit grid (defaults to the planning grid)
        self._char_freqs_arg = char_freqs
        self._char_cores_arg = char_cores
        self.char_freqs = tuple(
            self.engine.freq_grid if char_freqs is None else char_freqs
        )
        self.char_cores = tuple(
            self.engine.chip_grid if char_cores is None else char_cores
        )
        self.negotiator = negotiator
        self.migration = migration
        self.lookahead = lookahead
        # the lookahead seed machinery is the Negotiator's slot mode; a
        # scheduler without a configured negotiator still needs it to
        # replay the greedy seed over (point × node × slot) options
        self._slot_negotiator = (
            negotiator
            if negotiator is not None
            else Negotiator(pool, self.engine.power)
        )
        # mixed mode negotiates per device family: each family's rounds
        # need that family's fitted power surface for option projection
        # (knobs copied from the user's negotiator when one is set)
        self._negotiators: Optional[Dict[str, Negotiator]] = None
        if self.engines is not None:
            kw = {}
            if negotiator is not None:
                kw = dict(
                    energy_margin=negotiator.energy_margin,
                    max_moves=negotiator.max_moves,
                    max_slots=negotiator.max_slots,
                    max_exchange_targets=negotiator.max_exchange_targets,
                )
            self._negotiators = {
                dev: Negotiator(pool, eng.power, **kw)
                for dev, eng in self.engines.items()
            }
        self.rounds: List[RoundLog] = []
        self.completed: List[CompletedJob] = []
        self._pending: List[Job] = []
        self._finish_queue: List[CompletedJob] = []
        # telemetry family -> the engine cache key its jobs actually plan
        # under (family_key for profiled apps, the Job.terms instance for
        # artifact jobs) — re-characterization must refresh the same key
        self._family_keys: Dict[Family, object] = {}
        # telemetry family -> device: which engine a refreshed fit
        # installs into (mixed mode; None values route to self.engine)
        self._family_device: Dict[Family, Optional[str]] = {}
        # last refresh's believed-scale ratio per family (new/old) — the
        # migration pass's materiality signal
        self._refit_ratio: Dict[Family, float] = {}
        # -- service-layer seams (repro_torch.fleet.service) --------------------
        # All empty/None in lockstep mode: zero behavior change unless an
        # event-driven service attaches itself.
        #   _launch_observers: called with each enqueued CompletedJob so
        #       the service can stream the completion onto its event bus;
        #   _preempt_observers: called with (CompletedJob, now) when a
        #       migration removes an in-flight segment, so the service can
        #       invalidate the segment's stale completion event;
        #   _executor: when set, replaces the direct node run — worker
        #       NodeManagers claim placements through it;
        #   _carry: job_id -> (energy_j, time_s, migrations, restarts)
        #       priors from segments killed by a node failure, merged into
        #       the job's next launch so the ledger stays honest;
        #   _installed_sets: family -> (terms, X, y) behind every
        #       telemetry-installed fit — what crash recovery must re-fit
        #       (deterministically) to rebuild the engine cache.
        self._launch_observers: List = []
        self._preempt_observers: List = []
        self._executor = None
        self._carry: Dict[int, Tuple[float, float, int, int]] = {}
        self._installed_sets: Dict[Family, tuple] = {}

    # -- the believed model ------------------------------------------------

    def _device_of(self, job: Job) -> Optional[str]:
        """The device group a job plans in: None in single-engine mode
        (every device routing question degenerates to the legacy path)."""
        return None if self.engines is None else job.device

    def _engine_for(self, device: Optional[str]) -> PlanningEngine:
        """The planning engine of one device group (``self.engine`` for
        the single-engine scheduler)."""
        return self.engine if device is None else self.engines[device]

    def _char_grids(self, device: Optional[str]):
        """The (freqs, cores) re-characterization grid of one device
        group — explicit constructor grids for the single-engine path,
        each device's own planning grid in mixed mode."""
        if device is None or self.engines is None:
            return self.char_freqs, self.char_cores
        eng = self.engines[device]
        if eng is self.engine:  # explicit args bind the reference device
            return self.char_freqs, self.char_cores
        return tuple(eng.freq_grid), tuple(eng.chip_grid)

    def _terms_key(self, job: Job):
        """The engine cache key of one job's workload family."""
        key = (
            job.terms
            if job.terms is not None
            else family_key(job.app, job.input_size)
        )
        self._family_keys[(job.app, job.input_size)] = key
        self._family_device[(job.app, job.input_size)] = self._device_of(job)
        return key

    def _workload(self, job: Job, now: float, free_cap: int) -> Workload:
        slack_s = job.deadline_s - now
        # A job already past its deadline gets max_time_s = 0.0, NOT None:
        # the empty time mask routes it through the engine's
        # on_infeasible="fastest" path (fastest point that still honors
        # the core cap). The seed passed None, which planned a late job
        # *unconstrained* — the leisurely energy optimum, maximizing the
        # overshoot instead of cutting it.
        return Workload(
            arch=job.app,
            terms=self._terms_key(job),
            constraints=Constraints(
                max_cores=free_cap,
                max_time_s=slack_s if slack_s > 0 else 0.0,
            ),
        )

    def _future_workload(self, job: Job, now: float, max_cores: int) -> Workload:
        """The lookahead view of a known future arrival: slack is still
        measured from ``now`` (one time origin per round) but the engine
        shifts it by ``earliest_start_s`` — the job cannot start before it
        arrives, so its frontier is masked by ``deadline - arrival``."""
        slack_s = job.deadline_s - now
        return Workload(
            arch=job.app,
            terms=self._terms_key(job),
            constraints=Constraints(
                max_cores=max_cores,
                max_time_s=slack_s if slack_s > 0 else 0.0,
            ),
            earliest_start_s=job.arrival_s - now,
        )

    # -- one scheduling round ---------------------------------------------

    def step(self, now: float) -> RoundLog:
        """Run ONE scheduling round at sim time ``now`` (seconds).

        The round is the subsystem's core loop:

        1. ingest completions (finish time <= now) into telemetry;
        2. refresh every drift-flagged family in one ``svr.fit_many``
           batch and install the models (``PlanningEngine.install_fit``);
        3. if a refresh materially moved a family's surface and a
           ``MigrationPolicy`` is set, re-plan that family's in-flight
           jobs (one ``pareto_many`` batch) and preempt/relaunch the ones
           whose believed remaining-energy saving clears the migration
           cost;
        4. plan + place every pending job in ONE batched engine pass
           (``Constraints(max_cores=free cores, max_time_s=deadline
           slack)``): with a ``Negotiator`` configured, that pass is
           ``pareto_many`` (the frontier's cheapest feasible point IS the
           energy argmin, so a separate ``plan_many`` would recompute the
           identical objective tensor) feeding the fleet-wide joint
           assignment; otherwise it is ``plan_many`` feeding the per-job
           cheapest-first fallback. Launch what fits.

        With a ``LookaheadPolicy``, step 4 is horizon-aware: the previous
        round's tentative holds are released, the known future arrivals
        inside the horizon join the SAME batched ``pareto_many`` pass
        (slack shifted to their arrival via ``Workload.earliest_start_s``),
        and the joint assignment runs over (frontier point × node × start
        slot) options — ready jobs whose slot is ``now`` launch; every
        other assignment becomes a tentative reservation.

        Returns the round's ``RoundLog`` (also appended to ``rounds``).
        Energies throughout are joules, times seconds, frequencies GHz.
        """
        with obs.span("fleet.round", cat="fleet", sim_t_s=now):
            log = self._step_impl(now)
        if obs.enabled():
            self._export_round_metrics(log, now)
        return log

    def _export_round_metrics(self, log: RoundLog, now: float) -> None:
        """Flight-recorder rollup for one round (recording runs only —
        ``step`` gates on ``obs.enabled()``)."""
        reg = obs.metrics_registry()
        reg.counter("fleet.rounds").inc()
        reg.counter("fleet.jobs_placed").inc(log.n_placed)
        reg.counter("fleet.migrations").inc(log.n_migrated)
        reg.counter("fleet.tentative_holds").inc(log.n_tentative)
        reg.counter("fleet.future_planned").inc(log.n_future)
        reg.histogram("fleet.round.pending_jobs").observe(log.n_pending)
        self.telemetry.export_staleness_gauges(reg, now)

    def _step_impl(self, now: float) -> RoundLog:
        self._ingest(now)
        eps = time_eps(now)
        if self.lookahead is not None:
            # last round's holds are provisional by contract: release and
            # re-plan them with this round's fresh capacity + telemetry
            self.pool.release_tentative()
        with obs.span("fleet.refresh", cat="fleet", sim_t_s=now):
            refit = self._refresh_stale(now)
        with obs.span("fleet.migrate", cat="fleet", sim_t_s=now):
            n_migrated = self._maybe_migrate(now, refit)
        pending_now = [j for j in self._pending if j.arrival_s <= now + eps]
        future: List[Job] = []
        if self.lookahead is not None:
            horizon_s = now + self.lookahead.horizon_s
            future = [
                j
                for j in self._pending
                if now + eps < j.arrival_s <= horizon_s
            ]
        # one placement group per device family (a single group, device
        # None, for the single-engine scheduler — the legacy path with an
        # unchanged call sequence); a group plans when it has ready jobs
        # AND a compatible node with free capacity
        if self.engines is None:
            groups = [(None, pending_now, future)]
        else:
            devs: List[str] = []
            for j in pending_now + future:
                if j.device not in devs:
                    devs.append(j.device)
            groups = [
                (
                    d,
                    [j for j in pending_now if j.device == d],
                    [j for j in future if j.device == d],
                )
                for d in devs
            ]
        active = []
        for dev, ready, fut in groups:
            cap = self.pool.max_free_cores(now, dev)
            if ready and cap > 0:
                active.append((dev, ready, fut, cap))
        planned = bool(active)
        log = RoundLog(
            now=now,
            n_pending=len(pending_now),
            planned=planned,
            refit_families=refit,
            # only rounds that actually placed through the Negotiator count
            negotiated=planned and self.negotiator is not None,
            n_migrated=n_migrated,
            n_future=sum(len(fut) for _, _, fut, _ in active),
        )
        if log.planned:
            with obs.span(
                "fleet.place", cat="fleet", sim_t_s=now,
                n_ready=len(pending_now), n_future=log.n_future,
            ):
                for dev, ready, fut, cap in active:
                    if self.lookahead is not None:
                        self._place_lookahead(ready, fut, now, log, device=dev)
                    elif self.negotiator is not None:
                        workloads = [
                            self._workload(j, now, cap) for j in ready
                        ]
                        self._place_negotiated(
                            ready, workloads, now, log, device=dev
                        )
                    else:
                        workloads = [
                            self._workload(j, now, cap) for j in ready
                        ]
                        # THE one batched call (per device family)
                        plans = self._engine_for(dev).plan_many(workloads)
                        order = sorted(
                            range(len(ready)),
                            key=lambda i: (
                                ready[i].deadline_s,
                                ready[i].job_id,
                            ),
                        )
                        for i in order:
                            placement = self._place(
                                ready[i], workloads[i], plans[i], now
                            )
                            if placement is not None:
                                self._launch(placement)
                                self._pending.remove(ready[i])
                                log.n_placed += 1
        self.rounds.append(log)
        return log

    def _place_lookahead(
        self,
        ready: List[Job],
        future: List[Job],
        now: float,
        log: RoundLog,
        device: Optional[str] = None,
    ) -> None:
        """The horizon-aware round: ready jobs AND known future arrivals in
        ONE batched ``pareto_many``, then the slot-mode joint assignment
        over (frontier point × node × start slot).

        Ready jobs assigned a launch-now slot run immediately; assignments
        with a future start (a ready job waiting for a better window, or a
        future arrival) become tentative reservations — capacity holds the
        next round confirms (by launching) or releases (by re-planning).

        By construction: the search never worsens the seed's (deferred,
        misses, projected joules) over the round's planned set, and a
        round with NO future arrivals seeds exactly the myopic greedy —
        pure-ready rounds cannot be worse than myopic. A mixed round is
        deliberately EDF-flavored: a tighter-deadline future arrival may
        out-rank a looser ready job for contested capacity (the horizon
        exists to make that trade); the fleet-level lookahead <= myopic
        ordering is enforced empirically by the comparison report's
        ``engine-myopic`` gate and the stranding-trace tests.
        """
        jobs = ready + future
        cap = self.pool.max_free_cores(now, device)
        biggest = max(
            n.spec.max_cores for n in self.pool.nodes_for(device)
        )
        # Ready jobs keep the MYOPIC core cap (max free cores at `now`),
        # deliberately: the slot seed walks each ready job's frontier
        # exactly as the myopic greedy would, and that only replays
        # myopic if the frontier is IDENTICAL (a wider frontier can drop
        # capped-frontier points as dominated). The cost is that a ready
        # job's later start slots are limited to <= cap cores; a deadline
        # squeezed by that cap resolves next round, when the job re-plans
        # against the then-free capacity — exactly as the myopic
        # scheduler would. Future jobs carry no myopic twin, so they plan
        # against the biggest node outright.
        workloads = [self._workload(j, now, cap) for j in ready] + [
            self._future_workload(j, now, biggest) for j in future
        ]
        # THE one batched call (per device family)
        frontiers = self._engine_for(device).pareto_many(workloads)
        # device-incompatible nodes expose ZERO capacity to this group's
        # negotiation: every (point, node) option on them is pruned by the
        # ordinary capacity check, so enumeration needs no device branch
        profiles = [
            n.capacity_profile(include_tentative=False)
            if device is None or n.spec.device == device
            else CapacityProfile(0)
            for n in self.pool
        ]
        negotiator = (
            self._slot_negotiator
            if self._negotiators is None
            else self._negotiators[device]
        )
        with obs.span(
            "fleet.negotiate", cat="fleet", sim_t_s=now,
            slotted=True, n_jobs=len(jobs),
        ):
            result = negotiator.negotiate(
                jobs,
                [w.terms for w in workloads],
                frontiers,
                (),  # scalar free-core counts: unused in slot mode
                [j.deadline_s - now for j in jobs],
                now=now,
                arrivals=[j.arrival_s for j in jobs],
                profiles=profiles,
                search=self.negotiator is not None,
            )
        log.n_moves = result.n_moves
        log.n_exchanges = result.n_exchanges
        eps = time_eps(now)
        for i, opt in enumerate(result.assignments):
            if opt is None:
                continue  # deferred: replanned in the next round's batch
            job = jobs[i]
            node = self.pool[opt.node_idx]
            if i < len(ready) and opt.start_s <= now + eps:
                placement = Placement(
                    job=job,
                    node=node.name,
                    frequency_ghz=opt.frequency_ghz,
                    cores=opt.cores,
                    start_s=now,
                    predicted_time_s=opt.time_s,
                    predicted_energy_j=opt.energy_j,
                    pareto_fallback=opt.point_idx != len(frontiers[i]) - 1,
                    negotiated=self.negotiator is not None,
                )
                self._launch(placement)
                self._pending.remove(job)
                log.n_placed += 1
            else:
                # a capacity hold, not an execution: the job stays pending
                node.reserve(
                    opt.start_s, opt.end_s, opt.cores, job.job_id,
                    tentative=True,
                )
                self.telemetry.record_tentative(
                    TentativeRecord(
                        time_s=now,
                        family=(job.app, job.input_size),
                        job_id=job.job_id,
                        node=node.name,
                        start_s=opt.start_s,
                        end_s=opt.end_s,
                        cores=opt.cores,
                    )
                )
                log.n_tentative += 1

    def _place_negotiated(
        self,
        pending_now: List[Job],
        workloads: List[Workload],
        now: float,
        log: RoundLog,
        device: Optional[str] = None,
    ) -> None:
        """The negotiated round: ONE batched ``pareto_many`` over every
        pending job (the round's single engine pass — fits, grid
        prediction and objective tensor shared with any later call), then
        the fleet-wide joint assignment. The negotiation seed replays the
        cheapest-first fallback, so the launched assignment's projected
        (deferred, misses, joules) is never worse."""
        frontiers = self._engine_for(device).pareto_many(workloads)
        terms_list = [w.terms for w in workloads]
        # device-incompatible nodes offer zero free cores to this group:
        # the ordinary ``cores <= free`` option filter prunes them
        free = [
            n.free_cores(now)
            if device is None or n.spec.device == device
            else 0
            for n in self.pool
        ]
        slacks = [j.deadline_s - now for j in pending_now]
        negotiator = (
            self.negotiator
            if self._negotiators is None
            else self._negotiators[device]
        )
        with obs.span(
            "fleet.negotiate", cat="fleet", sim_t_s=now,
            slotted=False, n_jobs=len(pending_now),
        ):
            result = negotiator.negotiate(
                pending_now, terms_list, frontiers, free, slacks
            )
        log.n_moves = result.n_moves
        log.n_exchanges = result.n_exchanges
        for i, opt in enumerate(result.assignments):
            if opt is None:
                continue  # deferred: replanned in the next round's batch
            placement = Placement(
                job=pending_now[i],
                node=self.pool[opt.node_idx].name,
                frequency_ghz=opt.frequency_ghz,
                cores=opt.cores,
                start_s=now,
                predicted_time_s=opt.time_s,
                predicted_energy_j=opt.energy_j,
                # any point other than the frontier's cheapest (= last)
                # spent extra joules on feasibility
                pareto_fallback=opt.point_idx != len(frontiers[i]) - 1,
                negotiated=True,
            )
            self._launch(placement)
            self._pending.remove(pending_now[i])
            log.n_placed += 1

    # -- placement: energy-aware bin-pack + pareto deadline fallback -------

    def _candidates(
        self,
        now: float,
        terms,
        cores: int,
        f: float,
        ref_time_s: float,
        slack_s: float,
        require_deadline: bool,
        device: Optional[str] = None,
    ) -> List[Tuple[float, int, FleetNode, float, float]]:
        """(expected energy, node index, node, expected time, snapped f),
        cheapest first — "plan energy × node skew" over device-compatible
        nodes with capacity.

        A node whose frequency table cannot reach the planned f will run at
        its snapped (usually lower) frequency; the believed surface
        ``terms`` supplies the time ratio between the two, so the deadline
        check, the bin-pack score and the telemetry prediction all describe
        the run the node will actually execute."""
        power_model = self._engine_for(device).power
        out = []
        for idx, node in enumerate(self.pool):
            if device is not None and node.spec.device != device:
                continue
            if node.free_cores(now) < cores:
                continue
            # one point × M nodes for a single job's fallback placement —
            # below the vectorization payoff  # repro: allow(vectorize-enumeration)
            f_snap, t_exp, e_exp = project_point(
                node.spec, power_model, terms, cores, f, ref_time_s
            )
            if require_deadline and t_exp > slack_s:
                continue
            out.append((e_exp, idx, node, t_exp, f_snap))
        return sorted(out, key=lambda c: (c[0], c[1]))

    def _place(
        self, job: Job, workload: Workload, plan: EnergyPlan, now: float
    ) -> Optional[Placement]:
        slack_s = job.deadline_s - now
        dev = self._device_of(job)
        frontier = None
        # First pass honors the deadline; if nothing in the pool can make
        # it, the second pass places for minimum energy and eats the miss
        # (better a late cheap job than a starved queue).
        terms = workload.terms
        passes = (True, False) if slack_s > 0 else (False,)
        for require_deadline in passes:
            cand = self._candidates(
                now, terms, plan.chips, plan.frequency_ghz, plan.step_time_s,
                slack_s, require_deadline, device=dev,
            )
            if cand:
                e_exp, _, node, t_exp, f_snap = cand[0]
                return Placement(
                    job=job,
                    node=node.name,
                    frequency_ghz=f_snap,
                    cores=plan.chips,
                    start_s=now,
                    predicted_time_s=t_exp,
                    predicted_energy_j=e_exp,
                    pareto_fallback=False,
                )
            # deadline (or capacity) infeasible at the energy optimum: walk
            # the frontier cheapest-first and buy the missing feasibility
            # with the fewest extra joules. pareto() is deterministic
            # (time-sorted, energy tie-break), so this walk is reproducible.
            if frontier is None:
                # one deadline-infeasible job on the rare fallback path,
                # memoized across both passes — not a per-round N-job loop
                # repro: allow(batched-hot-path)
                frontier = self._engine_for(dev).pareto(workload)
            for point in reversed(frontier):  # slowest/cheapest first
                cand = self._candidates(
                    now, terms, point.chips, point.frequency_ghz,
                    point.step_time_s, slack_s, require_deadline, device=dev,
                )
                if cand:
                    e_exp, _, node, t_exp, f_snap = cand[0]
                    return Placement(
                        job=job,
                        node=node.name,
                        frequency_ghz=f_snap,
                        cores=point.chips,
                        start_s=now,
                        predicted_time_s=t_exp,
                        predicted_energy_j=e_exp,
                        pareto_fallback=True,
                    )
        return None  # defer: replanned in the next round's batch

    # -- execution + sensing ----------------------------------------------

    def _node_by_name(self, name: str) -> FleetNode:
        for node in self.pool:
            if node.name == name:
                return node
        raise KeyError(name)

    def _run_on(self, node: FleetNode, job: Job, f: float, p: int) -> RunResult:
        """Execute one job on one node. The dispatch mirrors the planning
        dispatch (``Job.terms``): a terms-backed job runs on its own base
        surface even when its app name collides with a profiled
        application — planning and execution must describe the same
        workload or telemetry would read the mismatch as drift."""
        if job.terms is None:
            return node.run_fixed(job.app, f, p, job.input_size)
        base = getattr(job.terms, "base", job.terms)  # truth: unscaled surface
        return node.run_terms(job.app, base, f, p)

    def _launch(
        self,
        placement: Placement,
        *,
        prior_energy_j: float = 0.0,
        prior_time_s: float = 0.0,
        migrations: int = 0,
        restarts: int = 0,
        work_frac: float = 1.0,
    ) -> None:
        """Run a placement (or, after a preemption, the ``work_frac``
        remainder of one) and enqueue its completion."""
        job = placement.job
        node = self._node_by_name(placement.node)
        run = self._run_on if self._executor is None else self._executor
        result = run(node, job, placement.frequency_ghz, placement.cores)
        if work_frac < 1.0:  # the remainder of a preempted job
            result = node.rescale(result, work_frac)
        finish = placement.start_s + result.time_s
        node.reserve(placement.start_s, finish, placement.cores, job.job_id)
        # merge priors carried over from segments a node failure killed
        ce, ct, cm, cr = self._carry.pop(job.job_id, (0.0, 0.0, 0, 0))
        completed = CompletedJob(
            placement=placement,
            result=result,
            finish_s=finish,
            met_deadline=finish <= job.deadline_s + time_eps(job.deadline_s),
            prior_energy_j=prior_energy_j + ce,
            prior_time_s=prior_time_s + ct,
            migrations=migrations + cm,
            restarts=restarts + cr,
        )
        self._finish_queue.append(completed)
        for cb in self._launch_observers:
            cb(completed)

    def _ingest(self, now: float) -> None:
        """Stream finished runs (finish time <= now) into telemetry."""
        due = [c for c in self._finish_queue if c.finish_s <= now + time_eps(now)]
        due_ids = {id(c) for c in due}
        self._finish_queue = [
            c for c in self._finish_queue if id(c) not in due_ids
        ]
        due.sort(key=lambda c: (c.finish_s, c.placement.job.job_id))
        for c in due:
            p = c.placement
            self.telemetry.record(
                Observation(
                    family=(p.job.app, p.job.input_size),
                    node=p.node,
                    frequency_ghz=p.frequency_ghz,
                    cores=p.cores,
                    input_size=p.job.input_size,
                    predicted_time_s=p.predicted_time_s,
                    measured_time_s=c.result.time_s,
                    predicted_energy_j=p.predicted_energy_j,
                    measured_energy_j=c.result.energy_j,
                    finish_s=c.finish_s,
                )
            )
            self.completed.append(c)

    # -- online re-characterization ----------------------------------------

    def _epoch_observations(self, family: Family) -> List:
        """Only observations from the CURRENT refresh epoch: ratios must be
        measured against the belief that produced their predictions, or
        compounding onto ``time_scale`` double-counts drift learned by an
        earlier refresh (and pre-refresh anchors drag the surface back)."""
        return self.telemetry.family_observations(
            family, since_s=self.telemetry.last_refresh_s(family)
        )

    def _drift_scale(self, family: Family, old_terms) -> float:
        """Telemetry-estimated truth/believed time ratio for one family,
        compounded onto whatever earlier refreshes already learned."""
        window = self._epoch_observations(family)
        window = window[-self.telemetry.detector.window:]
        ratios = [
            o.measured_time_s / max(o.predicted_time_s, 1e-12) for o in window
        ]
        if not ratios:  # defensive: a stale flag implies epoch observations
            return old_terms.time_scale
        return old_terms.time_scale * float(np.mean(ratios))

    def _refit_set(self, terms: AppTerms, family: Family, device=None):
        """Training set for one refreshed family: the believed surface
        rescaled by the telemetry-estimated drift on the (char_freqs ×
        char_cores) grid of the family's device, anchored by the family's
        recent real observations mapped back to reference scale. No new
        measurement runs — the refit is paid for by joules the fleet
        already burned (a dedicated re-characterization sweep would cost
        unaccounted energy and skew the governor comparison)."""
        char_freqs, char_cores = self._char_grids(device)
        feats, times = [], []
        for f in char_freqs:
            for c in char_cores:
                feats.append((float(f), float(c)))
                times.append(max(terms.step_time(float(f), int(c)), TIME_FLOOR))
        for o in self._epoch_observations(family):
            spec = self._node_by_name(o.node).spec
            feats.append((o.frequency_ghz, float(o.cores)))
            times.append(max(o.measured_time_s / spec.speed_skew, TIME_FLOOR))
        return np.asarray(feats, np.float32), np.asarray(times, np.float32)

    def _refresh_stale(self, now: float) -> List[Family]:
        """Refresh every drift-flagged family in ONE ``svr.fit_many`` batch
        and install the refreshed models into the engine cache. Works for
        profiled-app families (``AppTerms``) and artifact families
        (``TermsFamily``) alike: the refreshed believed surface is the old
        one with its ``time_scale`` re-estimated from telemetry. Records
        each family's scale ratio (new/old) in ``_refit_ratio`` — the
        migration pass's materiality signal."""
        stale = self.telemetry.stale_families()
        self._refit_ratio = {}
        if not stale:
            return []
        obs.counter("fleet.drift_detections").inc(len(stale))
        obs.event(
            "fleet.drift", cat="fleet", sim_t_s=now,
            families=[f"{app}:{size:g}" for app, size in stale],
        )
        keys = [
            self._family_keys.get(fam, family_key(*fam)) for fam in stale
        ]
        # mixed mode: each family refits on, and installs into, its own
        # device's engine — but the fit batch below stays ONE call
        fam_devs = [self._family_device.get(fam) for fam in stale]
        new_terms = []
        for fam, key, dev in zip(stale, keys, fam_devs):
            old = self._engine_for(dev).cached_terms(key) or key
            scale = self._drift_scale(fam, old)
            self._refit_ratio[fam] = scale / max(old.time_scale, 1e-12)
            new_terms.append(
                dataclasses.replace(old, time_scale=scale, source="telemetry")
            )
        sets = [
            self._refit_set(t, fam, dev)
            for t, fam, dev in zip(new_terms, stale, fam_devs)
        ]
        # method="auto": small telemetry windows refit on the exact dual
        # solve; windows past svr.RFF_THRESHOLD observations take the
        # linear random-Fourier-feature path (one batch either way)
        models = svr_mod.fit_many(
            sets, method="auto", device=self.engine.device, **ENGINE_FIT_KW
        )
        preds = svr_mod.predict_each(models, [x for x, _ in sets])
        for fam, key, dev, terms, model, (x, y), pred in zip(
            stale, keys, fam_devs, new_terms, models, sets, preds
        ):
            self._engine_for(dev).install_fit(
                key, model, svr_mod.pae_from_pred(pred, y), terms
            )
            # remember the training set: crash recovery re-fits it to
            # rebuild this cache entry (see fleet/service/store.py)
            self._installed_sets[fam] = (terms, x, y)
            self.telemetry.mark_refreshed(fam, now)
        obs.counter("fleet.refits").inc(len(stale))
        return stale

    # -- preemptive rebalancing after a material re-fit ---------------------

    def _maybe_migrate(self, now: float, refit: List[Family]) -> int:
        """Re-plan in-flight jobs of materially re-characterized families.

        A drift re-fit can reveal that a running job's placement is no
        longer near its energy optimum (the family got slower, so staying
        put now costs more believed joules than moving). For every
        in-flight job of a family whose refreshed ``time_scale`` moved by
        at least ``MigrationPolicy.min_drift``, this pass:

        1. estimates the believed remaining work fraction from the
           *refreshed* surface projected onto the job's current node;
        2. re-plans all candidates in ONE ``pareto_many`` batch (capacity
           excludes each job's own reservation — "where could it go if it
           left?", deadline slack rescaled to the full-run frame);
        3. projects each frontier point onto each node with capacity and
           preempts + relaunches the remainder wherever the believed
           remaining-energy saving clears ``cost_j`` plus the
           ``min_saving_frac`` margin. Never migrates a job that is
           believed on-deadline into a believed miss.

        Returns the number of jobs migrated. All accounting is honest:
        the abandoned segment's measured joules and the migration charge
        ride on the job's ``CompletedJob.prior_energy_j``, the old
        reservation is truncated at the preemption instant, and telemetry
        keeps a ``PreemptionRecord`` per move.
        """
        pol = self.migration
        if pol is None or not refit:
            return 0
        material = {
            fam
            for fam in refit
            if abs(self._refit_ratio.get(fam, 1.0) - 1.0) >= pol.min_drift
        }
        if not material:
            return 0
        candidates = []
        workloads = []
        for c in self._finish_queue:
            job = c.placement.job
            fam = (job.app, job.input_size)
            if (
                c.finish_s <= now + time_eps(now)
                or fam not in material
                or c.migrations >= pol.max_migrations_per_job
            ):
                continue
            dev = self._device_of(job)
            engine = self._engine_for(dev)
            key = self._terms_key(job)
            terms = engine.cached_terms(key) or key  # refreshed belief
            node = self._node_by_name(c.placement.node)
            t_full = node.spec.expected_time(
                terms.step_time(c.placement.frequency_ghz, c.placement.cores)
            )
            elapsed = now - c.placement.start_s
            remaining_frac = 1.0 - elapsed / max(t_full, 1e-12)
            if remaining_frac < pol.min_remaining_frac:
                continue
            # one call per drift-flagged in-flight job (its CURRENT node
            # only, no grid)  # repro: allow(vectorize-enumeration)
            _, _, e_full = project_point(
                node.spec, engine.power, terms, c.placement.cores,
                c.placement.frequency_ghz, terms.step_time(
                    c.placement.frequency_ghz, c.placement.cores
                ),
            )
            slack_s = job.deadline_s - now
            free_cap = max(
                n.free_cores(now, exclude_job=job.job_id)
                for n in self.pool.nodes_for(dev)
            )
            candidates.append(
                (c, terms, remaining_frac, e_full * remaining_frac, slack_s,
                 dev)
            )
            workloads.append(
                Workload(
                    arch=job.app,
                    terms=key,
                    constraints=Constraints(
                        max_cores=free_cap,
                        # the frontier speaks full-run times; the remainder
                        # only runs remaining_frac of them. slack_s <= 0 is
                        # the same past-deadline case as _workload: 0.0
                        # (fastest-feasible), never None (unconstrained)
                        max_time_s=(
                            slack_s / remaining_frac if slack_s > 0 else 0.0
                        ),
                    ),
                )
            )
        if not candidates:
            return 0
        if self.engines is None:
            frontiers = self.engine.pareto_many(workloads)  # ONE batched pass
        else:
            # mixed mode: ONE batched pass per device family present
            frontiers: List = [None] * len(workloads)
            by_dev: Dict[Optional[str], List[int]] = {}
            for i, cand in enumerate(candidates):
                by_dev.setdefault(cand[5], []).append(i)
            for dev, idxs in by_dev.items():
                frs = self._engine_for(dev).pareto_many(
                    [workloads[i] for i in idxs]
                )
                for i, fr in zip(idxs, frs):
                    frontiers[i] = fr
        migrated = 0
        for (c, terms, r_b, e_remain_cur, slack_s, dev), frontier in zip(
            candidates, frontiers
        ):
            job = c.placement.job
            power_model = self._engine_for(dev).power
            # believed on-deadline status of the current placement
            node_cur = self._node_by_name(c.placement.node)
            t_remain_cur = node_cur.spec.expected_time(
                terms.step_time(c.placement.frequency_ghz, c.placement.cores)
            ) * r_b
            meets_now = slack_s > 0 and t_remain_cur <= slack_s
            best = None
            for pt in frontier:
                for idx, node in enumerate(self.pool):
                    if dev is not None and node.spec.device != dev:
                        continue
                    free = node.free_cores(now, exclude_job=job.job_id)
                    if pt.chips > free:
                        continue
                    # per-job free-cores gate interleaves with the
                    # projection, and migrations are rare (gated by
                    # min_drift) — the K·M win does not apply
                    # repro: allow(vectorize-enumeration)
                    f_snap, t_exp, e_exp = project_point(
                        node.spec, power_model, terms, pt.chips,
                        pt.frequency_ghz, pt.step_time_s,
                    )
                    if meets_now and slack_s > 0 and r_b * t_exp > slack_s:
                        continue  # never trade an on-deadline job into a miss
                    cand = (r_b * e_exp, idx, f_snap, t_exp, pt)
                    if best is None or cand[:2] < best[:2]:
                        best = cand
            if best is None:
                continue
            e_remain_new, idx, f_snap, t_exp, pt = best
            saving = e_remain_cur - (e_remain_new + pol.cost_j)
            if saving <= pol.min_saving_frac * e_remain_cur:
                continue
            self._preempt_and_relaunch(
                c, now, self.pool[idx], f_snap, pt.chips,
                r_b, t_exp, e_remain_new, saving,
            )
            migrated += 1
        return migrated

    def _preempt_and_relaunch(
        self,
        c: CompletedJob,
        now: float,
        node: FleetNode,
        f_snap: float,
        cores: int,
        believed_frac: float,
        t_exp_full: float,
        e_remain_new: float,
        saving_j: float,
    ) -> None:
        """Stop a running job, charge what it burned, relaunch the rest."""
        pol = self.migration
        job = c.placement.job
        old_node = self._node_by_name(c.placement.node)
        # truth-side progress: the sim knows the run's actual total time
        elapsed = now - c.placement.start_s
        done_frac = min(elapsed / c.result.time_s, 1.0)
        burned = c.result.energy_j * done_frac
        remaining_true = max(1.0 - done_frac, 0.0)
        old_node.truncate_reservation(job.job_id, now)
        self._finish_queue.remove(c)
        for cb in self._preempt_observers:
            cb(c, now)
        self.telemetry.record_preemption(
            PreemptionRecord(
                time_s=now,
                family=(job.app, job.input_size),
                job_id=job.job_id,
                from_node=old_node.name,
                to_node=node.name,
                burned_j=burned,
                migration_cost_j=pol.cost_j,
                projected_saving_j=saving_j,
                start_s=c.placement.start_s,
                cores=c.placement.cores,
            )
        )
        obs.event(
            "fleet.preempt", cat="fleet", sim_t_s=now,
            job_id=job.job_id, from_node=old_node.name, to_node=node.name,
            burned_j=burned, projected_saving_j=saving_j,
        )
        placement = Placement(
            job=job,
            node=node.name,
            frequency_ghz=f_snap,
            cores=cores,
            start_s=now,
            predicted_time_s=believed_frac * t_exp_full,
            predicted_energy_j=e_remain_new,
            pareto_fallback=c.placement.pareto_fallback,
            negotiated=c.placement.negotiated,
            migrated_from=old_node.name,
        )
        self._launch(
            placement,
            prior_energy_j=c.prior_energy_j + burned + pol.cost_j,
            prior_time_s=c.prior_time_s + elapsed,
            migrations=c.migrations + 1,
            restarts=c.restarts,
            work_frac=remaining_true,
        )

    # -- the simulation driver ---------------------------------------------

    def run(
        self,
        jobs: Sequence[Job],
        *,
        drift_events: Sequence[Tuple[float, str, float]] = (),
        max_rounds: int = 10_000,
    ) -> List[CompletedJob]:
        """Simulate the whole trace: rounds fire at job arrivals, job
        completions and drift-event times until the queue drains.

        ``drift_events`` are (sim time, app, time factor) truth shifts
        applied fleet-wide — the scheduler is not told; telemetry notices.

        This is the LOCKSTEP driver — the event-driven
        ``repro_torch.fleet.service.SchedulerService`` replays the identical
        schedule from its event bus (bitwise on joules, misses, makespan
        and per-job configs), so this loop doubles as the parity oracle
        for the service core.
        """
        self._pending = sorted(jobs, key=lambda j: (j.arrival_s, j.job_id))
        events = sorted(drift_events)
        ei = 0
        now = 0.0
        for _ in range(max_rounds):
            if not (self._pending or self._finish_queue):
                break
            ei = apply_due_events(self.pool, events, ei, now)
            self.step(now)
            nxt = next_event_time(self.pool, self._pending, events, ei, now)
            if nxt is None:
                break  # unplaceable remainder: nothing left to wait for
            now = nxt
        self.pool.release_tentative()  # holds are plans; the sim is over
        self._ingest(float("inf"))
        return self.completed

    # -- summary -----------------------------------------------------------

    @property
    def makespan_s(self) -> float:
        return max((c.finish_s for c in self.completed), default=0.0)

    def total_energy_j(self) -> float:
        """Joules the fleet actually spent, including every preempted
        partial segment and migration charge (honest accounting)."""
        return float(sum(c.total_energy_j for c in self.completed))

    def deadline_misses(self) -> int:
        return sum(not c.met_deadline for c in self.completed)

    def migrations(self) -> int:
        return sum(c.migrations for c in self.completed)

    def utilization(self) -> Dict[str, float]:
        return self.pool.utilization(self.makespan_s)
