"""Fleet-scale comparison report: engine scheduling vs stock-governor FIFO.

The fleet analogue of ``core.evaluate``'s Tables 2-5 loop. The same job
trace (and the same mid-simulation drift events) runs under:

* **engine** — ``FleetScheduler``: one ``plan_many`` per round, energy-aware
  bin-pack, pareto deadline fallback, online re-characterization;
* **each stock governor** — naive FIFO placement (first node with free
  cores, grab them all) with the node's DVFS managed by the governor, i.e.
  what a cluster looks like when nobody plans.

Per-scenario totals (joules, makespan, per-node utilization, deadline
misses) live in ``ScenarioStats``; the per-job engine-vs-governor energy
ratios are assembled into a genuine ``evaluate.ComparisonReport``, so the
node-level and fleet-level reports share ONE serialization path
(``ComparisonReport.to_json`` / ``from_json``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.core.evaluate import (
    STOCK_GOVERNORS,
    ComparisonReport,
    GovernorRun,
    PlanRun,
    make_governor,
)
from repro_torch.fleet.cluster import NodePool, make_mixed_pool, make_pool, time_eps
from repro_torch.fleet.negotiate import Negotiator
from repro_torch.fleet.scheduler import (
    FleetScheduler,
    Job,
    LookaheadPolicy,
    MigrationPolicy,
    apply_due_events,
    fleet_engine,
    next_event_time,
    tpu_fleet_engine,
)
from repro_torch.fleet.telemetry import TelemetryHub


@dataclasses.dataclass
class ScenarioStats:
    """One fleet scenario (engine or one governor) over the whole trace."""

    name: str
    total_energy_j: float
    makespan_s: float
    utilization: Dict[str, float]
    deadline_misses: int
    n_jobs: int
    job_energy_j: Dict[int, float]
    job_time_s: Dict[int, float]
    recharacterizations: int = 0
    pareto_fallbacks: int = 0
    # preemptive rebalancing (0 for governors and the fallback scheduler):
    # moves made, and the joules those moves wasted (abandoned segments +
    # migration charges) — already included in total/job energies, broken
    # out so migration cannot hide its cost
    preemptions: int = 0
    migration_energy_j: float = 0.0
    negotiation_exchanges: int = 0
    # horizon-aware lookahead (0 for every other scenario): the configured
    # horizon and how many tentative capacity holds its rounds placed
    lookahead_horizon_s: float = 0.0
    tentative_reservations: int = 0
    # flight-recorder rollup ({} unless the run was recorded): the
    # registry DELTA attributable to this scenario (counters/gauges/
    # histograms — see repro_torch.obs.metrics.diff). Purely observational:
    # it is the ONE field allowed to differ between a traced and an
    # untraced run of the same scenario, which the bitwise-parity test
    # asserts by stripping it before comparing.
    obs_rollup: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        # json keys are strings; keep the loader symmetric
        d["job_energy_j"] = {str(k): v for k, v in self.job_energy_j.items()}
        d["job_time_s"] = {str(k): v for k, v in self.job_time_s.items()}
        return d

    @classmethod
    def from_json(cls, payload: dict) -> "ScenarioStats":
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in payload.items() if k in fields}
        d["job_energy_j"] = {
            int(k): v for k, v in payload.get("job_energy_j", {}).items()
        }
        d["job_time_s"] = {
            int(k): v for k, v in payload.get("job_time_s", {}).items()
        }
        return cls(**d)


# ---------------------------------------------------------------------------
# the naive baseline: stock governor + FIFO placement
# ---------------------------------------------------------------------------


def run_governor_fleet(
    pool: NodePool,
    jobs: Sequence[Job],
    governor_name: str,
    *,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    max_rounds: int = 10_000,
) -> ScenarioStats:
    """FIFO the trace through the pool under one stock governor.

    Placement is what an unplanned cluster does: first node (by index) with
    any free cores takes the job on ALL of them; the governor manages the
    frequency. Deadlines are not consulted — misses are counted after the
    fact.
    """
    pending = sorted(jobs, key=lambda j: (j.arrival_s, j.job_id))
    events = sorted(drift_events)
    ei = 0
    now = 0.0
    job_energy_j: Dict[int, float] = {}
    job_time_s: Dict[int, float] = {}
    finishes: Dict[int, float] = {}
    misses = 0
    for _ in range(max_rounds):
        if not pending and pool.next_completion(now) is None:
            break
        ei = apply_due_events(pool, events, ei, now)
        still_pending = []
        for job in pending:
            if job.arrival_s > now + time_eps(now):
                still_pending.append(job)
                continue
            placed = False
            for node in pool:
                free = node.free_cores(now)  # instantaneous ledger query
                if free <= 0:
                    continue
                gov = make_governor(governor_name, node.spec.freq_table)
                result = node.run_governor(job.app, gov, free, job.input_size)
                finish = now + result.time_s
                node.reserve(now, finish, free, job.job_id)
                job_energy_j[job.job_id] = result.energy_j
                job_time_s[job.job_id] = result.time_s
                finishes[job.job_id] = finish
                misses += finish > job.deadline_s + time_eps(job.deadline_s)
                placed = True
                break
            if not placed:
                still_pending.append(job)
        pending = still_pending
        nxt = next_event_time(pool, pending, events, ei, now)
        if nxt is None:
            break
        now = nxt
    makespan_s = max(finishes.values(), default=0.0)
    return ScenarioStats(
        name=governor_name,
        total_energy_j=float(sum(job_energy_j.values())),
        makespan_s=makespan_s,
        utilization=pool.utilization(makespan_s),
        deadline_misses=int(misses),
        n_jobs=len(job_energy_j),
        job_energy_j=job_energy_j,
        job_time_s=job_time_s,
    )


def run_fixed_fleet(
    pool: NodePool,
    jobs: Sequence[Job],
    *,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    max_rounds: int = 10_000,
    name: str = "fixed-max",
) -> ScenarioStats:
    """The mixed-pool naive baseline: FIFO placement at full tilt.

    What an unplanned heterogeneous cluster does: each job takes the first
    DEVICE-COMPATIBLE node (by index) with free capacity, grabs ALL of its
    free cores/chips, and runs pinned at the node's highest table
    frequency — race-to-idle with nobody planning (f, p). Works for
    profiled apps and terms-backed (artifact) jobs alike, so it is the
    governor-FIFO analogue for pools whose devices have no DVFS governor
    model (a TPU slice has no ``ondemand``).
    """
    pending = sorted(jobs, key=lambda j: (j.arrival_s, j.job_id))
    events = sorted(drift_events)
    ei = 0
    now = 0.0
    job_energy_j: Dict[int, float] = {}
    job_time_s: Dict[int, float] = {}
    finishes: Dict[int, float] = {}
    misses = 0
    for _ in range(max_rounds):
        if not pending and pool.next_completion(now) is None:
            break
        ei = apply_due_events(pool, events, ei, now)
        still_pending = []
        for job in pending:
            if job.arrival_s > now + time_eps(now):
                still_pending.append(job)
                continue
            placed = False
            for node in pool:
                if node.spec.device != job.device:
                    continue
                free = node.free_cores(now)  # instantaneous ledger query
                if free <= 0:
                    continue
                f_max = node.spec.freq_table[-1]
                if job.terms is None:
                    result = node.run_fixed(
                        job.app, f_max, free, job.input_size
                    )
                else:
                    base = getattr(job.terms, "base", job.terms)
                    result = node.run_terms(job.app, base, f_max, free)
                finish = now + result.time_s
                node.reserve(now, finish, free, job.job_id)
                job_energy_j[job.job_id] = result.energy_j
                job_time_s[job.job_id] = result.time_s
                finishes[job.job_id] = finish
                misses += finish > job.deadline_s + time_eps(job.deadline_s)
                placed = True
                break
            if not placed:
                still_pending.append(job)
        pending = still_pending
        nxt = next_event_time(pool, pending, events, ei, now)
        if nxt is None:
            break
        now = nxt
    makespan_s = max(finishes.values(), default=0.0)
    return ScenarioStats(
        name=name,
        total_energy_j=float(sum(job_energy_j.values())),
        makespan_s=makespan_s,
        utilization=pool.utilization(makespan_s),
        deadline_misses=int(misses),
        n_jobs=len(job_energy_j),
        job_energy_j=job_energy_j,
        job_time_s=job_time_s,
    )


def run_engine_fleet(
    pool: NodePool,
    jobs: Sequence[Job],
    *,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    engine=None,
    telemetry: Optional[TelemetryHub] = None,
    char_freqs=None,
    char_cores=None,
    negotiate: bool = False,
    migration: Optional[MigrationPolicy] = None,
    lookahead: Optional[LookaheadPolicy] = None,
    service: bool = False,
    service_kw: Optional[dict] = None,
    name: str = "engine",
) -> Tuple[ScenarioStats, FleetScheduler]:
    """The planned fleet: one ``FleetScheduler`` over the whole trace.

    ``negotiate=True`` places rounds via fleet-wide pareto negotiation;
    ``migration`` (a ``MigrationPolicy``) enables the preemptive
    rebalancing pass — both off reproduces the cheapest-first
    scheduler exactly. ``lookahead`` (a ``LookaheadPolicy``) makes every
    round horizon-aware: known future arrivals join the batched pass and
    hold capacity with tentative reservations. Per-job energies include
    preempted partial segments and migration charges.

    ``service=True`` pumps the run through the event-driven
    ``SchedulerService`` instead of the lockstep loop (bitwise-identical
    schedule by contract); ``service_kw`` passes through to its
    constructor (``journal=...``, ``kill_at_s=...``, ...).
    """
    engine = engine if engine is not None else fleet_engine(pool)
    # `engine` may be a per-device dict (mixed pools); the negotiator knob
    # donor just needs SOME power model — FleetScheduler rebuilds one
    # negotiator per device from it in mixed mode.
    rep_engine = (
        engine[pool.reference.spec.device] if isinstance(engine, dict) else engine
    )
    sched = FleetScheduler(
        pool,
        engine,
        telemetry,
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiator=Negotiator(pool, rep_engine.power) if negotiate else None,
        migration=migration,
        lookahead=lookahead,
    )
    # snapshot the registry around the run so the rollup is THIS
    # scenario's delta, not the whole process history (several scenarios
    # share one recording in a comparison run)
    reg = obs.metrics_registry()
    before = reg.snapshot() if reg.enabled else None
    if service:
        # deferred import: the service layer is optional machinery on
        # top of the scheduler, not a report dependency
        from repro_torch.fleet.service import SchedulerService

        svc = SchedulerService(sched, **dict(service_kw or {}))
        completed = svc.run(jobs, drift_events=drift_events)
    else:
        completed = sched.run(jobs, drift_events=drift_events)
    rollup = (
        obs_metrics.diff(before, reg.snapshot()) if reg.enabled else {}
    )
    stats = ScenarioStats(
        name=name,
        total_energy_j=sched.total_energy_j(),
        makespan_s=sched.makespan_s,
        utilization=sched.utilization(),
        deadline_misses=sched.deadline_misses(),
        n_jobs=len(completed),
        # both axes include preempted segments: per-job energy AND time
        # must describe the same physical run or implied power lies
        job_energy_j={
            c.placement.job.job_id: c.total_energy_j for c in completed
        },
        job_time_s={
            c.placement.job.job_id: c.total_time_s for c in completed
        },
        recharacterizations=sched.telemetry.n_recharacterizations,
        pareto_fallbacks=sum(c.placement.pareto_fallback for c in completed),
        preemptions=sched.telemetry.n_preemptions,
        migration_energy_j=sched.telemetry.migration_energy_j,
        negotiation_exchanges=sum(r.n_exchanges for r in sched.rounds),
        lookahead_horizon_s=lookahead.horizon_s if lookahead else 0.0,
        tentative_reservations=sched.telemetry.n_tentative_reservations,
        obs_rollup=rollup,
    )
    return stats, sched


def run_myopic_reference(
    jobs: Sequence[Job],
    *,
    n_nodes: int,
    seed: int,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    engine_kw: Optional[dict] = None,
    char_freqs=None,
    char_cores=None,
    negotiate: bool = False,
    migration: Optional[MigrationPolicy] = None,
) -> ScenarioStats:
    """The ``engine-myopic`` comparison row: identical trace, pool seeds
    and negotiation/migration configuration, NO lookahead — what the
    horizon bought. One definition, shared by the governor comparison and
    the artifact-intake report."""
    mpool = make_pool(n_nodes, seed=seed)
    stats, _ = run_engine_fleet(
        mpool,
        jobs,
        drift_events=drift_events,
        engine=fleet_engine(mpool, **dict(engine_kw or {})),
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiate=negotiate,
        migration=migration,
        name="engine-myopic",
    )
    return stats


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetReport:
    """Fleet totals per scenario + the shared per-job comparison report."""

    scenarios: Dict[str, ScenarioStats]  # "engine" + one per governor
    comparison: ComparisonReport  # per-job ratios, evaluate.py serialization

    @property
    def engine(self) -> ScenarioStats:
        return self.scenarios["engine"]

    def baseline_names(self) -> List[str]:
        """Every scenario the engine is compared against — the stock
        governors plus, when present, the ``engine-fallback`` (the
        cheapest-first, no negotiation/migration) reference."""
        return [n for n in self.scenarios if n != "engine"]

    def governor_names(self) -> List[str]:
        return [n for n in self.baseline_names() if not n.startswith("engine")]

    def energy_ratio(self, scenario: str) -> float:
        return self.scenarios[scenario].total_energy_j / max(
            self.engine.total_energy_j, 1e-12
        )

    def engine_beats_all(self, tol: float = 0.05) -> bool:
        """Fleet-level paper ordering: the engine-scheduled fleet spends
        <= every baseline fleet's joules (tol absorbs sim noise) —
        governors AND, when present, the cheapest-first fallback."""
        return all(
            self.energy_ratio(g) >= 1.0 - tol for g in self.baseline_names()
        )

    def table(self) -> str:
        lines = [
            f"{'scenario':<16}{'E kJ':>10}{'ratio':>8}{'makespan s':>12}"
            f"{'util%':>8}{'misses':>8}{'refits':>8}{'migr':>6}",
            "-" * 76,
        ]
        order = ["engine"] + self.baseline_names()
        for name in order:
            s = self.scenarios[name]
            util = sum(s.utilization.values()) / max(len(s.utilization), 1)
            ratio = self.energy_ratio(name) if name != "engine" else 1.0
            lines.append(
                f"{name:<16}{s.total_energy_j / 1e3:>10.1f}{ratio:>7.2f}x"
                f"{s.makespan_s:>12.0f}{100 * util:>7.1f}%"
                f"{s.deadline_misses:>8d}{s.recharacterizations:>8d}"
                f"{s.preemptions:>6d}"
            )
        ratios = (
            "per-job governor/engine energy ratios: "
            f"best {self.comparison.best_case_ratio:.2f}x, "
            f"mean {self.comparison.mean_ratio:.2f}x, "
            f"worst {self.comparison.worst_case_ratio:.2f}x; "
            if self.comparison.runs  # artifact traces have no governor runs
            else ""
        )
        lookahead = (
            f"; lookahead horizon: {self.engine.lookahead_horizon_s:.0f} s, "
            f"tentative holds: {self.engine.tentative_reservations}"
            if self.engine.lookahead_horizon_s > 0
            else ""
        )
        lines.append(
            ratios
            + f"pareto deadline fallbacks: {self.engine.pareto_fallbacks}; "
            f"negotiation exchanges: {self.engine.negotiation_exchanges}; "
            f"migration overhead: {self.engine.migration_energy_j / 1e3:.1f} kJ"
            + lookahead
        )
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "scenarios": {n: s.to_json() for n, s in self.scenarios.items()},
            "comparison": self.comparison.to_json(),
        }

    @classmethod
    def from_json(cls, payload: dict) -> "FleetReport":
        return cls(
            scenarios={
                n: ScenarioStats.from_json(s)
                for n, s in payload["scenarios"].items()
            },
            comparison=ComparisonReport.from_json(payload["comparison"]),
        )


def build_comparison(
    engine_stats: ScenarioStats,
    governor_stats: Sequence[ScenarioStats],
    jobs: Sequence[Job],
    completed,
) -> ComparisonReport:
    """Per-job ratios as a genuine ``ComparisonReport`` (shared schema)."""
    by_id = {j.job_id: j for j in jobs}
    plans = []
    placements = {c.placement.job.job_id: c.placement for c in completed}
    for jid in sorted(engine_stats.job_energy_j):
        job = by_id[jid]
        p = placements[jid]
        plans.append(
            PlanRun(
                app=job.app,
                input_size=job.input_size,
                frequency_ghz=p.frequency_ghz,
                cores=p.cores,
                predicted_energy_j=p.predicted_energy_j,
                time_s=engine_stats.job_time_s[jid],
                energy_j=engine_stats.job_energy_j[jid],
            )
        )
    runs = []
    for gs in governor_stats:
        for jid in sorted(gs.job_energy_j):
            job = by_id[jid]
            e_engine = engine_stats.job_energy_j.get(jid)
            if e_engine is None:
                continue
            runs.append(
                GovernorRun(
                    app=job.app,
                    input_size=job.input_size,
                    governor=gs.name,
                    cores=0,  # FIFO grabs whatever was free, not one count
                    time_s=gs.job_time_s[jid],
                    energy_j=gs.job_energy_j[jid],
                    ratio=gs.job_energy_j[jid] / max(e_engine, 1e-12),
                )
            )
    return ComparisonReport(plans=plans, runs=runs)


def run_fleet_comparison(
    jobs: Sequence[Job],
    *,
    n_nodes: int = 4,
    seed: int = 0,
    governors: Sequence[str] = STOCK_GOVERNORS,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    engine_kw: Optional[dict] = None,
    char_freqs=None,
    char_cores=None,
    negotiate: bool = False,
    migration: Optional[MigrationPolicy] = None,
    lookahead: Optional[LookaheadPolicy] = None,
    include_fallback: bool = False,
    include_myopic: bool = False,
) -> Tuple[FleetReport, FleetScheduler]:
    """Run the same trace under the engine and every governor.

    Every scenario gets a FRESH pool built from the same specs and seeds,
    so the ground truth (power skews, noise streams, drift) is identical
    and the only difference is who decides (f, p, node).

    ``negotiate``/``migration``/``lookahead`` configure the engine
    scenario; ``include_fallback`` adds an ``engine-fallback`` scenario —
    the cheapest-first scheduler with none of the three — and
    ``include_myopic`` (meaningful when ``lookahead`` is set) adds an
    ``engine-myopic`` scenario — same negotiation + migration but no
    horizon — so the report shows what each layer bought on the identical
    trace.
    """
    engine_kw = dict(engine_kw or {})
    pool = make_pool(n_nodes, seed=seed)
    engine = fleet_engine(pool, **engine_kw)
    engine_stats, sched = run_engine_fleet(
        pool,
        jobs,
        drift_events=drift_events,
        engine=engine,
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiate=negotiate,
        migration=migration,
        lookahead=lookahead,
    )
    scenarios = {"engine": engine_stats}
    if include_myopic and lookahead is not None:
        scenarios["engine-myopic"] = run_myopic_reference(
            jobs,
            n_nodes=n_nodes,
            seed=seed,
            drift_events=drift_events,
            engine_kw=engine_kw,
            char_freqs=char_freqs,
            char_cores=char_cores,
            negotiate=negotiate,
            migration=migration,
        )
    if include_fallback:
        fpool = make_pool(n_nodes, seed=seed)
        fb_stats, _ = run_engine_fleet(
            fpool,
            jobs,
            drift_events=drift_events,
            engine=fleet_engine(fpool, **engine_kw),
            char_freqs=char_freqs,
            char_cores=char_cores,
            name="engine-fallback",
        )
        scenarios["engine-fallback"] = fb_stats
    gov_stats = []
    for gname in governors:
        gpool = make_pool(n_nodes, seed=seed)
        gs = run_governor_fleet(gpool, jobs, gname, drift_events=drift_events)
        scenarios[gname] = gs
        gov_stats.append(gs)
    report = FleetReport(
        scenarios=scenarios,
        comparison=build_comparison(engine_stats, gov_stats, jobs, sched.completed),
    )
    return report, sched


def run_mixed_fleet_comparison(
    jobs: Sequence[Job],
    *,
    n_cpu: int = 2,
    n_tpu: int = 2,
    seed: int = 0,
    drift_events: Sequence[Tuple[float, str, float]] = (),
    cpu_engine_kw: Optional[dict] = None,
    tpu_engine_kw: Optional[dict] = None,
    char_freqs=None,
    char_cores=None,
    negotiate: bool = True,
    migration: Optional[MigrationPolicy] = None,
    lookahead: Optional[LookaheadPolicy] = None,
) -> Tuple[FleetReport, FleetScheduler]:
    """The heterogeneous-pool comparison: per-device engines vs fixed-max.

    Builds a ``make_mixed_pool`` (CPU nodes + TPU slices), hands the
    scheduler one ``PlanningEngine`` per device family — each planning in
    its own ``ConfigSpace`` over its own fitted power surface — and runs
    the trace. The baseline is ``run_fixed_fleet`` on a fresh twin pool:
    FIFO, all free capacity, top table frequency, no planning. Stock DVFS
    governors are not meaningful baselines here (a TPU slice has no
    governor model), so fixed-max is the whole comparison set.
    """
    pool = make_mixed_pool(n_cpu=n_cpu, n_tpu=n_tpu, seed=seed)
    engines = {
        "cpu": fleet_engine(pool, **dict(cpu_engine_kw or {})),
        "tpu": tpu_fleet_engine(pool, **dict(tpu_engine_kw or {})),
    }
    engine_stats, sched = run_engine_fleet(
        pool,
        jobs,
        drift_events=drift_events,
        engine=engines,
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiate=negotiate,
        migration=migration,
        lookahead=lookahead,
    )
    fpool = make_mixed_pool(n_cpu=n_cpu, n_tpu=n_tpu, seed=seed)
    fixed_stats = run_fixed_fleet(fpool, jobs, drift_events=drift_events)
    scenarios = {"engine": engine_stats, fixed_stats.name: fixed_stats}
    report = FleetReport(
        scenarios=scenarios,
        comparison=build_comparison(
            engine_stats, [fixed_stats], jobs, sched.completed
        ),
    )
    return report, sched
