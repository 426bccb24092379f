"""Fleet simulation entry point: ``python -m repro_torch.fleet [--quick]``.

Builds a heterogeneous ≥4-node pool and a deterministic job trace
(staggered arrivals, mixed applications/inputs, service-level deadlines),
injects a mid-simulation drift event (one application family silently gets
slower fleet-wide), and runs the trace under the engine scheduler — with
fleet-wide pareto negotiation and preemptive rebalancing enabled by
default — under the cheapest-first fallback (the ``engine-fallback``
row: same engine, no negotiation, no migration), and under every stock
governor with naive FIFO placement. Prints the fleet report: joules,
makespan and per-node utilization per scenario, per-job energy ratios,
deadline misses, pareto fallbacks, negotiation exchanges, preemptive
migrations (with their honest energy overhead) and the number of
drift-triggered re-characterizations.

``--artifacts DIR`` switches the intake: every ``launch/dryrun.py`` JSON
record in DIR becomes one fleet job via
``characterize.workloads_from_artifacts`` (the believed surface is the
artifact's roofline terms wrapped in ``cluster.TermsFamily``), and the
full intake → negotiate → migrate loop runs on those records. Stock
governors need the node profile table, so the artifact comparison is
engine vs engine-fallback.

``--service`` pumps the engine scenario through the event-driven
``SchedulerService`` (bitwise-identical schedule by contract) instead of
the lockstep comparison loop. ``--journal FILE`` makes the run durable
(one atomic snapshot per event batch); ``--kill-at T`` simulates a crash
at sim time T (the process "dies", the journal survives), and
``--resume FILE`` restarts a killed run from its journal and drains it
to completion — the resumed schedule matches the uninterrupted one
bitwise. The journal's format is the JAX package's, so ``--resume`` also
takes a journal that ``python -m repro.fleet`` wrote.

The planning engines run on the CUDA device unless ``--device cpu`` asks
for the host; ``--resume`` takes the device from its own command line
(the journal's run configuration holds no device).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core import tpu_power
from repro_torch.core.characterize import workloads_from_artifacts
from repro_torch.core.node_sim import F_MAX, FREQ_GRID, PROFILES
from repro_torch.fleet.cluster import TermsFamily, make_mixed_pool, make_pool
from repro_torch.fleet.report import (
    build_comparison,
    run_engine_fleet,
    run_fleet_comparison,
    run_mixed_fleet_comparison,
    run_myopic_reference,
    FleetReport,
)
from repro_torch.fleet.scheduler import (
    Job,
    LookaheadPolicy,
    MigrationPolicy,
    fleet_engine,
    tpu_fleet_engine,
)

DRIFT_APP = "raytrace"
DRIFT_FACTOR = 1.6

# the model-zoo workload families a mixed pool's TPU slices serve (the
# same shapes the tpu_planner bench seeds plans for)
TPU_ZOO_WORKLOADS = (
    ("qwen1.5-110b", "train_4k"),
    ("gemma3-12b", "prefill_32k"),
    ("starcoder2-3b", "train_4k"),
    ("mamba2-130m", "train_4k"),
)


def build_jobs(
    n_jobs: int,
    *,
    seed: int = 0,
    apps: Sequence[str] = tuple(sorted(PROFILES)),
    input_sizes: Sequence[float] = (1.0, 2.0, 3.0),
    arrival_spacing_s: float = 220.0,
    slack_range=(1.4, 4.0),
    burst: int = 1,
) -> List[Job]:
    """A deterministic trace: apps cycle, inputs/arrivals/slacks are seeded.

    Deadlines are arrival + slack × an optimistic service-time estimate
    (16 cores at f_max), so the tight end of ``slack_range`` forces the
    scheduler onto the pareto frontier while the loose end lets the energy
    optimum through.

    ``burst > 1`` makes the trace bursty: arrivals land in groups of
    ``burst`` jobs at the same instant, separated by ``burst`` × the mean
    spacing — the known-future-arrival pattern the horizon-aware
    scheduler (``--horizon``) exists for. Every burst mixes loose-deadline
    long jobs with tight-deadline short ones, so a myopic round can
    strand the cheap nodes on the long jobs just before the next burst
    needs them.
    """
    rng = np.random.default_rng(seed)
    jobs = []
    t = 0.0
    for i in range(n_jobs):
        app = apps[i % len(apps)]
        n = float(input_sizes[int(rng.integers(len(input_sizes)))])
        est_fast = PROFILES[app].time(F_MAX, 16, n)
        slack_factor = float(rng.uniform(*slack_range))
        jobs.append(
            Job(
                job_id=i,
                app=app,
                input_size=n,
                deadline_s=t + est_fast * slack_factor,
                arrival_s=t,
            )
        )
        if burst > 1:
            if (i + 1) % burst == 0:
                t += float(rng.uniform(0.4, 1.0)) * arrival_spacing_s * burst
        else:
            t += float(rng.uniform(0.2, 1.0)) * arrival_spacing_s
    return jobs


def build_artifact_jobs(
    dryrun_dir: str,
    *,
    seed: int = 0,
    arrival_spacing_s: float = 200.0,
    slack_range=(1.4, 4.0),
) -> List[Job]:
    """Every dry-run artifact as one fleet job (the intake wiring).

    ``workloads_from_artifacts`` supplies the engine ``Workload`` per
    record; here each becomes a ``Job`` whose believed surface is the
    artifact's roofline terms (``TermsFamily`` — frozen, so it doubles as
    the engine's characterization cache key), with a seeded arrival and a
    deadline slack off the optimistic 16-core/f_max service estimate.
    """
    workloads = workloads_from_artifacts(dryrun_dir)
    rng = np.random.default_rng(seed)
    jobs: List[Job] = []
    t = 0.0
    for i, w in enumerate(workloads):
        terms = TermsFamily(base=w.terms, app=f"{w.arch}:{w.shape_name}")
        est_fast = terms.step_time(F_MAX, 16)
        slack_factor = float(rng.uniform(*slack_range))
        jobs.append(
            Job(
                job_id=i,
                app=terms.app,
                input_size=terms.input_size,
                deadline_s=t + est_fast * slack_factor,
                arrival_s=t,
                terms=terms,
            )
        )
        t += float(rng.uniform(0.2, 1.0)) * arrival_spacing_s
    return jobs


def build_mixed_jobs(
    n_jobs: int,
    *,
    seed: int = 0,
    apps: Sequence[str] = tuple(sorted(PROFILES)),
    input_sizes: Sequence[float] = (1.0, 2.0, 3.0),
    arrival_spacing_s: float = 220.0,
    slack_range=(1.4, 4.0),
    tpu_every: int = 3,
    tpu_workloads=TPU_ZOO_WORKLOADS,
) -> List[Job]:
    """A heterogeneous trace: CPU apps with model-zoo TPU jobs interleaved.

    One arrival clock; every ``tpu_every``-th job is a TPU workload from
    the zoo. TPU believed surfaces come from ``launch/dryrun.py``
    artifacts when present, the analytic roofline otherwise — wrapped in
    ``TermsFamily`` whose ``time_scale`` is the family's seeded step
    count, so one job is a whole training segment (hundreds of steps),
    not one step. Deadlines are slack × the optimistic service estimate
    (256 chips at the TPU table max; 16 cores at f_max on CPU).
    """
    # lazy: the CPU-only trace never needs the zoo's shape tables
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.engine import terms_analytic, terms_from_dryrun

    rng = np.random.default_rng(seed)
    tpu_f_max = float(tpu_power.F_GRID[-1])
    families: List[TermsFamily] = []
    for arch_id, shape in tpu_workloads:
        base = terms_from_dryrun(arch_id, shape) or terms_analytic(
            arch_id, SHAPES[shape]
        )
        steps = float(rng.integers(60, 240))
        families.append(
            TermsFamily(base=base, app=f"{arch_id}:{shape}", time_scale=steps)
        )
    jobs: List[Job] = []
    t = 0.0
    fi = 0
    for i in range(n_jobs):
        if tpu_every > 0 and (i % tpu_every) == tpu_every - 1:
            fam = families[fi % len(families)]
            fi += 1
            est_fast = fam.step_time(tpu_f_max, 256)
            slack_factor = float(rng.uniform(*slack_range))
            jobs.append(
                Job(
                    job_id=i,
                    app=fam.app,
                    input_size=fam.input_size,
                    deadline_s=t + est_fast * slack_factor,
                    arrival_s=t,
                    terms=fam,
                    device="tpu",
                )
            )
        else:
            app = apps[i % len(apps)]
            n = float(input_sizes[int(rng.integers(len(input_sizes)))])
            est_fast = PROFILES[app].time(F_MAX, 16, n)
            slack_factor = float(rng.uniform(*slack_range))
            jobs.append(
                Job(
                    job_id=i,
                    app=app,
                    input_size=n,
                    deadline_s=t + est_fast * slack_factor,
                    arrival_s=t,
                )
            )
        t += float(rng.uniform(0.2, 1.0)) * arrival_spacing_s
    return jobs


def run_artifact_fleet(
    jobs: Sequence[Job],
    *,
    n_nodes: int,
    seed: int,
    engine_kw: dict,
    char_freqs,
    char_cores,
    drift_events,
    migration: Optional[MigrationPolicy],
    negotiate: bool,
    lookahead: Optional[LookaheadPolicy] = None,
):
    """Artifact traces: engine (negotiated) vs engine-fallback (and, with
    a horizon, engine-myopic) — stock governors cannot run apps outside
    the node profile table."""
    pool = make_pool(n_nodes, seed=seed)
    stats, sched = run_engine_fleet(
        pool,
        jobs,
        drift_events=drift_events,
        engine=fleet_engine(pool, **engine_kw),
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiate=negotiate,
        migration=migration,
        lookahead=lookahead,
    )
    scenarios = {"engine": stats}
    if lookahead is not None:
        # what the horizon bought: same negotiation/migration, no lookahead
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
    fpool = make_pool(n_nodes, seed=seed)
    scenarios["engine-fallback"], _ = run_engine_fleet(
        fpool,
        jobs,
        drift_events=drift_events,
        engine=fleet_engine(fpool, **engine_kw),
        char_freqs=char_freqs,
        char_cores=char_cores,
        name="engine-fallback",
    )
    report = FleetReport(
        scenarios=scenarios,
        comparison=build_comparison(stats, [], jobs, sched.completed),
    )
    return report, sched


def _grids(quick: bool, seed: int):
    """The run's grid configuration — shared by the fresh-run path and
    ``--resume`` (a resumed scheduler must be built from the SAME grids
    or the replayed schedule silently diverges)."""
    if quick:
        engine_kw = dict(
            freqs=tuple(float(f) for f in FREQ_GRID[::2]),
            cores=tuple(range(1, 33, 2)),
            noise=0.01,
            seed=seed,
        )
        tpu_kw = dict(
            freqs=tuple(float(f) for f in tpu_power.F_GRID[::2]),
            noise=0.01,
            seed=seed,
        )
        char_freqs = tuple(float(f) for f in FREQ_GRID[::3])
        char_cores = (1, 8, 16, 24, 32)
        input_sizes = (1.0, 2.0)
    else:
        engine_kw = dict(noise=0.01, seed=seed)
        tpu_kw = dict(noise=0.01, seed=seed)
        char_freqs = None  # planning grid
        char_cores = None
        input_sizes = (1.0, 2.0, 3.0)
    return engine_kw, tpu_kw, char_freqs, char_cores, input_sizes


def _build_scheduler_from_config(cfg: dict, device=None):
    """Rebuild the pool/engine/scheduler a journaled run was using from
    its snapshot ``config`` blob (the journal holds *state*; the config
    holds how to re-create the objects the state loads into), its
    engines on ``device``."""
    from repro_torch.fleet.scheduler import FleetScheduler, Negotiator

    engine_kw, tpu_kw, char_freqs, char_cores, _ = _grids(
        bool(cfg["quick"]), int(cfg["seed"])
    )
    engine_kw["device"] = tpu_kw["device"] = device
    if cfg.get("mixed"):
        pool = make_mixed_pool(
            n_cpu=int(cfg["n_cpu"]),
            n_tpu=int(cfg["n_tpu"]),
            seed=int(cfg["seed"]),
        )
        engine = {
            "cpu": fleet_engine(pool, **engine_kw),
            "tpu": tpu_fleet_engine(pool, **tpu_kw),
        }
        rep = engine[pool.reference.spec.device]
    else:
        pool = make_pool(int(cfg["nodes"]), seed=int(cfg["seed"]))
        engine = rep = fleet_engine(pool, **engine_kw)
    fallback = bool(cfg["fallback"])
    horizon_s = float(cfg["horizon_s"])
    return FleetScheduler(
        pool,
        engine,
        char_freqs=char_freqs,
        char_cores=char_cores,
        negotiator=None if fallback else Negotiator(pool, rep.power),
        migration=(
            None
            if fallback
            else MigrationPolicy(cost_j=float(cfg["migration_cost_j"]))
        ),
        lookahead=(
            LookaheadPolicy(horizon_s=horizon_s) if horizon_s > 0 else None
        ),
    )


def _resume(path: str, device=None):
    """``--resume FILE``: restart a killed ``--service --journal`` run
    from its last committed snapshot, its engines on ``device``, and
    drain it to completion."""
    from repro_torch.fleet.service import Journal, SchedulerService

    payload = Journal.load(path)
    cfg = payload["config"]
    if not cfg:
        raise SystemExit(
            f"{path}: journal has no run config — it was not written by "
            "`python -m repro_torch.fleet --service --journal` (or "
            "`python -m repro.fleet`)"
        )
    sched = _build_scheduler_from_config(cfg, device)
    service = SchedulerService.resume(path, sched)
    obs.log(
        f"resumed from {path}: sim t={payload['now_s']:.0f}s, "
        f"{payload['n_batches']} batches committed, "
        f"{len(payload['jobs']['completed'])} jobs already done"
    )
    service.drain()
    obs.log(
        f"service (resumed): {len(sched.completed)} jobs, "
        f"{sched.total_energy_j():.0f} J, makespan {sched.makespan_s:.0f} s, "
        f"{sched.deadline_misses()} deadline misses, "
        f"{service.n_batches} batches total"
    )
    return sched


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced grids/trace")
    ap.add_argument("--jobs", type=int, default=None, help="trace length")
    ap.add_argument("--nodes", type=int, default=4, help="pool size (>= 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="write the full report to this path")
    ap.add_argument(
        "--artifacts",
        metavar="DIR",
        help="build the job trace from launch/dryrun.py JSON records in DIR "
        "(engine vs engine-fallback comparison; governors need profiles)",
    )
    ap.add_argument(
        "--mixed",
        action="store_true",
        help="heterogeneous pool: CPU nodes + TPU slices (--nodes splits "
        "between them); the trace interleaves profiled CPU apps with "
        "model-zoo TPU jobs and each device family plans in its own "
        "ConfigSpace; baseline is the fixed-max-frequency FIFO fleet",
    )
    ap.add_argument(
        "--fallback",
        action="store_true",
        help="disable negotiation + migration (the cheapest-first "
        "scheduler) in the engine scenario",
    )
    ap.add_argument(
        "--horizon",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="lookahead horizon: plan known future arrivals this far ahead "
        "and hold capacity for them with tentative reservations (adds the "
        "engine-myopic scenario for comparison; 0 disables)",
    )
    ap.add_argument(
        "--burst",
        type=int,
        default=1,
        metavar="K",
        help="arrivals land in bursts of K jobs (default 1 = the smooth "
        "trace); bursty traces are where --horizon pays",
    )
    ap.add_argument(
        "--migration-cost-j",
        type=float,
        default=2_000.0,
        help="joules charged per preemptive migration",
    )
    ap.add_argument(
        "--service",
        action="store_true",
        help="run the engine scenario on the event-driven SchedulerService "
        "(bitwise-identical schedule to the lockstep loop) instead of the "
        "full comparison",
    )
    ap.add_argument(
        "--journal",
        metavar="FILE",
        help="with --service: commit one atomic state snapshot per event "
        "batch to FILE, so a killed run can be restarted with --resume",
    )
    ap.add_argument(
        "--kill-at",
        type=float,
        default=None,
        metavar="T",
        help="with --service --journal: simulate a crash at sim time T "
        "(the journal survives; restart with --resume)",
    )
    ap.add_argument(
        "--resume",
        metavar="FILE",
        help="restart a killed --service run from its journal and drain "
        "it to completion (the resumed schedule matches the uninterrupted "
        "one bitwise); takes a journal of either package",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="default: cuda; 'cpu' runs on the host",
    )
    ap.add_argument(
        "--trace",
        metavar="FILE",
        help="record the run with the flight recorder (repro_torch.obs) and "
        "write a Perfetto-loadable trace + metrics rollup + per-node "
        "timeline to FILE; scheduling results stay bitwise-identical "
        "to an untraced run (summarize with `python -m repro_torch.obs FILE`)",
    )
    args = ap.parse_args(argv)

    if args.resume:
        if args.service or args.artifacts or args.kill_at is not None:
            ap.error("--resume takes only the journal FILE (and --device)")
        return _resume(args.resume, args.device)
    if args.kill_at is not None and not (args.service and args.journal):
        ap.error("--kill-at needs --service and --journal (nothing to "
                 "resume from otherwise)")
    if args.journal and not args.service:
        ap.error("--journal needs --service")
    if args.service and args.artifacts:
        ap.error("--service cannot journal artifact jobs (Job.terms is "
                 "not serializable); drop one of the two")
    if args.mixed and args.artifacts:
        ap.error("--mixed builds its own model-zoo TPU trace; it cannot "
                 "also take --artifacts")

    n_jobs = args.jobs or (12 if args.quick else 32)
    engine_kw, tpu_kw, char_freqs, char_cores, input_sizes = _grids(
        args.quick, args.seed
    )
    engine_kw["device"] = tpu_kw["device"] = args.device
    # --mixed splits --nodes between the device families (default 4 = 2+2)
    n_cpu = args.nodes - args.nodes // 2
    n_tpu = args.nodes // 2

    negotiate = not args.fallback
    migration = (
        None if args.fallback else MigrationPolicy(cost_j=args.migration_cost_j)
    )
    lookahead = (
        LookaheadPolicy(horizon_s=args.horizon) if args.horizon > 0 else None
    )

    # --trace installs the flight recorder for the whole comparison run;
    # without it the nulls stay in place and the run is untraced/unchanged
    rec_ctx = (
        obs.recording() if args.trace else contextlib.nullcontext()
    )
    with rec_ctx as rec:
        if args.artifacts:
            jobs = build_artifact_jobs(args.artifacts, seed=args.seed)
            if not jobs:
                ap.error(
                    f"no usable dry-run artifacts under {args.artifacts!r}"
                )
            # drift the first artifact family mid-trace: the intake loop
            # must exercise re-characterization and (policy permitting)
            # migration
            drift_app = jobs[0].app
            drift_t = jobs[len(jobs) // 3].arrival_s + 1.0
            drift_events = [(drift_t, drift_app, DRIFT_FACTOR)]
            report, sched = run_artifact_fleet(
                jobs,
                n_nodes=args.nodes,
                seed=args.seed,
                engine_kw=engine_kw,
                char_freqs=char_freqs,
                char_cores=char_cores,
                drift_events=drift_events,
                migration=migration,
                negotiate=negotiate,
                lookahead=lookahead,
            )
        elif args.service:
            from repro_torch.fleet.service import ServiceKilled

            if args.mixed:
                jobs = build_mixed_jobs(
                    n_jobs, seed=args.seed, input_sizes=input_sizes
                )
                pool = make_mixed_pool(
                    n_cpu=n_cpu, n_tpu=n_tpu, seed=args.seed
                )
                engine = {
                    "cpu": fleet_engine(pool, **engine_kw),
                    "tpu": tpu_fleet_engine(pool, **tpu_kw),
                }
            else:
                jobs = build_jobs(
                    n_jobs,
                    seed=args.seed,
                    input_sizes=input_sizes,
                    burst=args.burst,
                )
                pool = make_pool(args.nodes, seed=args.seed)
                engine = fleet_engine(pool, **engine_kw)
            drift_t = jobs[len(jobs) // 3].arrival_s + 1.0
            drift_events = [(drift_t, DRIFT_APP, DRIFT_FACTOR)]
            service_kw = dict(
                journal=args.journal,
                kill_at_s=args.kill_at,
                # everything --resume needs to rebuild these objects
                config=dict(
                    quick=args.quick,
                    nodes=args.nodes,
                    seed=args.seed,
                    fallback=args.fallback,
                    horizon_s=args.horizon,
                    migration_cost_j=args.migration_cost_j,
                    mixed=args.mixed,
                    n_cpu=n_cpu,
                    n_tpu=n_tpu,
                ),
            )
            try:
                stats, sched = run_engine_fleet(
                    pool,
                    jobs,
                    drift_events=drift_events,
                    engine=engine,
                    char_freqs=char_freqs,
                    char_cores=char_cores,
                    negotiate=negotiate,
                    migration=migration,
                    lookahead=lookahead,
                    service=True,
                    service_kw=service_kw,
                    name="engine-service",
                )
            except ServiceKilled as exc:
                obs.log(
                    f"service killed at sim t={exc.time_s:.0f}s after "
                    f"{exc.n_batches} batches; resume with: "
                    f"python -m repro_torch.fleet --resume {exc.journal_path}"
                )
                return None
            obs.log(
                f"service: {stats.n_jobs} jobs, {stats.total_energy_j:.0f} J, "
                f"makespan {stats.makespan_s:.0f} s, "
                f"{stats.deadline_misses} deadline misses, "
                f"{len(sched.rounds)} reaction rounds"
                + (f"; journal: {args.journal}" if args.journal else "")
            )
            report = None  # single-scenario run: no comparison table
        elif args.mixed:
            jobs = build_mixed_jobs(
                n_jobs, seed=args.seed, input_sizes=input_sizes
            )
            drift_app = DRIFT_APP
            drift_t = jobs[len(jobs) // 3].arrival_s + 1.0
            drift_events = [(drift_t, drift_app, DRIFT_FACTOR)]
            # drift a TPU family too: the refit → migrate loop must work
            # on both sides of the heterogeneous pool
            tpu_apps = [j.app for j in jobs if j.device == "tpu"]
            if tpu_apps:
                drift_events.append((drift_t, tpu_apps[0], DRIFT_FACTOR))
            report, sched = run_mixed_fleet_comparison(
                jobs,
                n_cpu=n_cpu,
                n_tpu=n_tpu,
                seed=args.seed,
                drift_events=drift_events,
                cpu_engine_kw=engine_kw,
                tpu_engine_kw=tpu_kw,
                char_freqs=char_freqs,
                char_cores=char_cores,
                negotiate=negotiate,
                migration=migration,
                lookahead=lookahead,
            )
        else:
            jobs = build_jobs(
                n_jobs,
                seed=args.seed,
                input_sizes=input_sizes,
                burst=args.burst,
            )
            drift_app = DRIFT_APP
            # the drift event lands mid-trace: enough history before it to
            # trust the model, enough jobs after it to notice and profit
            # from the re-fit
            drift_t = jobs[len(jobs) // 3].arrival_s + 1.0
            drift_events = [(drift_t, drift_app, DRIFT_FACTOR)]
            report, sched = run_fleet_comparison(
                jobs,
                n_nodes=args.nodes,
                seed=args.seed,
                drift_events=drift_events,
                engine_kw=engine_kw,
                char_freqs=char_freqs,
                char_cores=char_cores,
                negotiate=negotiate,
                migration=migration,
                lookahead=lookahead,
                include_fallback=not args.fallback,
                include_myopic=lookahead is not None,
            )

        if report is not None:
            n_rounds = len(sched.rounds)
            n_planned = sum(r.planned for r in sched.rounds)
            mode = "fallback" if args.fallback else "negotiate+migrate"
            if lookahead is not None:
                mode += f"+lookahead({args.horizon:.0f}s)"
            obs.log(
                f"fleet: {args.nodes} nodes, {len(jobs)} jobs, "
                f"{n_rounds} rounds ({n_planned} with planning, {mode}), "
                f"drift {drift_app}x{DRIFT_FACTOR} @t={drift_t:.0f}s"
            )
            obs.log(report.table())
            ok = report.engine_beats_all(tol=0.05)
            refits = report.engine.recharacterizations
            obs.log(
                f"engine <= every baseline fleet (tol 5%): {ok}; "
                f"drift-triggered re-characterizations: {refits}"
            )
    if args.trace:
        payload = obs.write_trace(args.trace, rec, sched=sched)
        obs.log(
            f"flight recorder: {len(payload['traceEvents'])} trace events, "
            f"{payload['meta']['n_timeline_segments']} timeline segments "
            f"-> {args.trace} (summarize: python -m repro_torch.obs {args.trace})"
        )
    if args.json:
        doc = report.to_json() if report is not None else dataclasses.asdict(stats)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, default=float)
    return report if report is not None else stats


if __name__ == "__main__":
    main()
