"""The port's event-driven fleet service against the live JAX package.

The reference's service mechanics (``tests/test_service.py``), held on the
port at the same sizes (6-8 jobs, the quick grids, ``device="cpu"``):
the event bus's order and batching, the events' and the journal's wire
format, torn writes, schema refusal, ``fit_many``'s independence of batch
composition, the service against the port's own lockstep driver bit for
bit, node failures and heartbeat loss, and the kill switch. Beside them,
against the reference itself: the port's service schedule equals the JAX
package's service schedule (every job's placement, start, finish and
joules; the predicted energies, which carry the SVR's last-bit
differences, within ``PRED_REL``). The reference's fault property is a
hypothesis test over ``tmp_path``; here it runs on fixed seeds, two for
each fault kind. Crash recovery is ``test_torch_service_recovery.py``.
"""

import json
import math
import os
import types

import numpy as np
import pytest
import torch

from helpers import torch_faults as faults
from repro import fleet as ref_fleet
from repro.fleet import service as ref_service
from repro.fleet.service import core as ref_core
from repro.fleet.service import events as ref_ev
from repro_torch import fleet
from repro_torch.analysis import core as analysis_core
from repro_torch.analysis import rules as analysis_rules
from repro_torch.core import svr as svr_mod
from repro_torch.core.engine import ENGINE_FIT_KW
from repro_torch.core.node_sim import F_MAX, FREQ_GRID, PROFILES
from repro_torch.fleet import service
from repro_torch.fleet.cluster import time_eps
from repro_torch.fleet.service import (
    SERVICE_SCHEMA_VERSION,
    Event,
    EventBus,
    Journal,
    JournalTorn,
    SchedulerService,
    ServiceKilled,
)
from repro_torch.fleet.service import core, store
from repro_torch.fleet.service import events as ev

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plans' predicted energies carry the SVR's last-bit differences
PRED_REL = 5e-4
QUICK_FREQS = tuple(float(f) for f in FREQ_GRID[::3])
QUICK_CORES = (1, 2, 4, 8, 16, 24, 32)
QUICK_ENGINE_KW = dict(freqs=QUICK_FREQS, cores=QUICK_CORES, noise=0.01, seed=0)
APPS = sorted(PROFILES)
PORT = types.SimpleNamespace(fleet=fleet, service=service, engine_kw=dict(device=CPU))
REF = types.SimpleNamespace(fleet=ref_fleet, service=ref_service, engine_kw={})
# two seeds of each fault kind (torch_faults.single_fault_schedule) on the
# 3-node pool, each landing its fault: a node-down kills an in-flight segment
FAULT_SEEDS = {"node-down": (11, 30), "heartbeat-loss": (1, 6), "journal-torn": (0, 2)}


def build_scheduler(
    pkg=PORT, n_nodes=3, *, negotiate=False, migration=None, lookahead=None
):
    f = pkg.fleet
    pool = f.make_pool(n_nodes, seed=0)
    engine = f.fleet_engine(pool, **QUICK_ENGINE_KW, **pkg.engine_kw)
    return f.FleetScheduler(
        pool,
        engine,
        char_freqs=QUICK_FREQS[::2],
        char_cores=(1, 8, 16, 32),
        negotiator=f.Negotiator(pool, engine.power) if negotiate else None,
        migration=migration,
        lookahead=lookahead,
    )


def trace(n_jobs, *, pkg=PORT, spacing=150.0, slack=3.0, inputs=(1.0,)):
    jobs, t = [], 0.0
    for i in range(n_jobs):
        app = APPS[i % len(APPS)]
        n = inputs[i % len(inputs)]
        est = PROFILES[app].time(F_MAX, 16, n)
        jobs.append(pkg.fleet.Job(i, app, n, deadline_s=t + est * slack, arrival_s=t))
        t += spacing
    return jobs


def fingerprint(sched):
    """Everything "bitwise-identical schedule" means: per-job config,
    node, exact joules/times, deadline fate, migration/restart counts,
    plus the telemetry record the rounds produced."""
    return {
        "jobs": [
            (
                c.placement.job.job_id,
                c.placement.node,
                c.placement.frequency_ghz,
                c.placement.cores,
                c.total_energy_j,
                c.total_time_s,
                c.finish_s,
                c.met_deadline,
                c.migrations,
                c.restarts,
            )
            for c in sched.completed
        ],
        "rounds": len(sched.rounds),
        "refreshes": list(sched.telemetry.refreshes),
        "preemptions": [
            (p.job_id, p.time_s, p.burned_j)
            for p in sched.telemetry.preemptions
        ],
        "makespan_s": sched.makespan_s,
        "energy_j": sched.total_energy_j(),
        "misses": sched.deadline_misses(),
    }


def schedule_rows(sched):
    """The completed jobs as (job, node, f, cores, start, finish, joules,
    deadline, migrations, restarts) rows and their predicted energies."""
    rows = [
        (c.placement.job.job_id, c.placement.node, c.placement.frequency_ghz,
         c.placement.cores, c.placement.start_s, c.finish_s, c.total_energy_j,
         c.met_deadline, c.migrations, c.restarts)
        for c in sched.completed
    ]
    return rows, [c.placement.predicted_energy_j for c in sched.completed]


def assert_same_schedule(sched, ref_sched):
    """The port's schedule is the reference's: rows equal, predicted
    energies within PRED_REL."""
    rows, pred = schedule_rows(sched)
    ref_rows, ref_pred = schedule_rows(ref_sched)
    assert rows == ref_rows
    np.testing.assert_allclose(pred, ref_pred, rtol=PRED_REL, atol=0)
    assert sched.total_energy_j() == ref_sched.total_energy_j()
    assert len(sched.rounds) == len(ref_sched.rounds)


# ---------------------------------------------------------------------------
# the event bus: deterministic ordering, eps batching, staleness
# ---------------------------------------------------------------------------


def test_event_bus_orders_by_time_kind_then_fifo():
    bus = EventBus()
    bus.push(ev.arrival(10.0, 1))
    bus.push(ev.completion(10.0, 2, 0))
    bus.push(ev.drift(10.0, "raytrace", 1.5))
    bus.push(ev.arrival(10.0, 0))  # same (time, kind): FIFO after job 1
    bus.push(ev.tick(5.0))
    t, batch = bus.pop_batch()
    assert t == 5.0 and [e.kind for e in batch] == ["tick"]
    t, batch = bus.pop_batch()
    assert t == 10.0
    # dispatch priority: drift before completion before arrivals (FIFO)
    assert [(e.kind, e.job_id) for e in batch] == [
        ("drift", None),
        ("completion", 2),
        ("arrival", 1),
        ("arrival", 0),
    ]
    assert bus.pop_batch() == (None, [])


def test_event_bus_batches_within_time_eps():
    bus = EventBus()
    t0 = 1e7  # large sim time: the relative eps is what groups here
    bus.push(ev.arrival(t0, 0))
    bus.push(ev.completion(t0 + 0.5 * time_eps(t0), 1, 0))  # same instant
    bus.push(ev.arrival(t0 + 10.0, 2))  # clearly later
    t, batch = bus.pop_batch()
    assert t == t0 and len(batch) == 2
    t, batch = bus.pop_batch()
    assert t == t0 + 10.0 and len(batch) == 1


def test_event_bus_skips_stale_completions():
    bus = EventBus()
    bus.push(ev.completion(50.0, 7, gen=0))  # superseded by a relaunch
    bus.push(ev.completion(80.0, 7, gen=1))
    live = {7: 1}
    stale = lambda e: e.kind == "completion" and live.get(e.job_id) != e.gen
    t, batch = bus.pop_batch(stale)
    # the stale head must not set the batch instant
    assert t == 80.0 and [e.gen for e in batch] == [1]
    assert bus.pop_batch(stale) == (None, [])


def test_event_kinds_and_schema_equal_the_reference():
    assert ev.EVENT_KINDS == ref_ev.EVENT_KINDS
    assert SERVICE_SCHEMA_VERSION == ref_ev.SERVICE_SCHEMA_VERSION
    assert core._JOURNALED_KINDS == ref_core._JOURNALED_KINDS


def test_event_json_roundtrip_and_the_reference_wire():
    events = [
        (ev.arrival(12.5, 3), ref_ev.arrival(12.5, 3)),
        (ev.completion(99.0, 4, gen=2), ref_ev.completion(99.0, 4, gen=2)),
        (ev.drift(7.0, "swaptions", 1.8), ref_ev.drift(7.0, "swaptions", 1.8)),
        (ev.node_down(5.0, "eco-1"), ref_ev.node_down(5.0, "eco-1")),
        (ev.node_up(6.0, "eco-1"), ref_ev.node_up(6.0, "eco-1")),
        (ev.heartbeat(60.0, "ref-0"), ref_ev.heartbeat(60.0, "ref-0")),
        (ev.tick(0.0), ref_ev.tick(0.0)),
    ]
    for e, theirs in events:
        wire = json.loads(json.dumps(e.to_json()))
        assert Event.from_json(wire) == e
        assert json.dumps(e.to_json()) == json.dumps(theirs.to_json())
        assert ref_ev.Event.from_json(wire) == theirs
    with pytest.raises(ValueError):
        Event(0.0, "not-a-kind")


# ---------------------------------------------------------------------------
# the journal: atomic commits, schema pinning, torn-write injection
# ---------------------------------------------------------------------------


def test_journal_commit_is_atomic_under_torn_write(tmp_path):
    path = str(tmp_path / "journal.json")
    journal = Journal(path)
    first = {"schema_version": SERVICE_SCHEMA_VERSION, "now_s": 1.0, "x": 1}
    journal.commit(first)
    journal.fail_next_commit = True
    with pytest.raises(JournalTorn):
        journal.commit(
            {"schema_version": SERVICE_SCHEMA_VERSION, "now_s": 2.0, "x": 2}
        )
    # the torn commit left the previous document fully intact
    assert Journal.load(path) == first
    assert journal.commits == 1
    # the sim-time tear fires at the first commit at or after it, once
    journal.tear_at_s = 3.0
    journal.commit({"schema_version": SERVICE_SCHEMA_VERSION, "now_s": 2.5})
    with pytest.raises(JournalTorn):
        journal.commit({"schema_version": SERVICE_SCHEMA_VERSION, "now_s": 3.0})
    assert Journal.load(path)["now_s"] == 2.5
    assert ref_service.Journal.load(path) == Journal.load(path)


def test_journal_refuses_schema_mismatch(tmp_path):
    path = str(tmp_path / "journal.json")
    with open(path, "w") as f:
        json.dump({"schema_version": -1, "now_s": 0.0}, f)
    with pytest.raises(ValueError, match="schema version"):
        Journal.load(path)


def test_array_wire_takes_tensors_and_arrays_alike():
    x = np.asarray([[1.5, 8.0], [2.25, 16.0]], np.float32)
    want = store._array_to_json(x)
    assert want == {"dtype": "float32", "data": x.tolist()}
    assert store._array_to_json(torch.from_numpy(x)) == want
    back = store._array_from_json(json.loads(json.dumps(want)))
    assert back.dtype == np.float32 and np.array_equal(back, x)


def test_fit_many_is_batch_composition_independent():
    """The recovery refit's soundness anchor: re-fitting a journaled
    training set in a DIFFERENT batch than the one the live service used
    must produce the bitwise-same model."""
    rng = np.random.default_rng(0)
    sets = []
    for i in range(3):
        x = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (12, 2)), np.float32)
        y = np.asarray(10.0 / x[:, 0] + 50.0 / x[:, 1] + i, np.float32)
        sets.append((x, y))
    grid = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (40, 2)), np.float32)
    batched = svr_mod.fit_many(sets, method="auto", device=CPU, **ENGINE_FIT_KW)
    for i in range(3):
        alone = svr_mod.fit_many([sets[i]], method="auto", device=CPU, **ENGINE_FIT_KW)
        pred_alone = svr_mod.predict_each(alone, [grid])[0]
        pred_batched = svr_mod.predict_each([batched[i]], [grid])[0]
        assert torch.equal(pred_alone, pred_batched), (
            "fit_many models depend on batch composition — recovery refits unsound"
        )


# ---------------------------------------------------------------------------
# replay determinism: event-driven == lockstep, bitwise; == the reference
# ---------------------------------------------------------------------------


def _drift_for(jobs):
    return [(jobs[len(jobs) // 3].arrival_s + 1.0, "raytrace", 1.6)]


def _mode_kw(pkg, mode):
    f = pkg.fleet
    return dict(
        fallback=dict(),
        negotiated=dict(negotiate=True, migration=f.MigrationPolicy()),
        lookahead=dict(
            negotiate=True,
            migration=f.MigrationPolicy(),
            lookahead=f.LookaheadPolicy(horizon_s=600.0),
        ),
    )[mode]


@pytest.fixture(scope="module", params=["fallback", "negotiated", "lookahead"])
def shipped_mode(request):
    """One shipped scenario shape, run three ways: the port's lockstep
    driver, the port's service, the reference's service."""
    mode = request.param
    out = {}
    for label, pkg in (("lockstep", PORT), ("service", PORT), ("ref", REF)):
        jobs = trace(8, pkg=pkg)
        sched = build_scheduler(pkg, **_mode_kw(pkg, mode))
        if label == "lockstep":
            sched.run(jobs, drift_events=_drift_for(jobs))
        else:
            pkg.service.SchedulerService(sched).run(jobs, drift_events=_drift_for(jobs))
        out[label] = sched
    return mode, out


def test_service_matches_lockstep_bitwise_on_shipped_shapes(shipped_mode):
    """Every shipped scenario shape (cheapest-first fallback, negotiated +
    migration, horizon-aware lookahead) reproduces bitwise under the
    event-driven core."""
    _, runs = shipped_mode
    assert fingerprint(runs["service"]) == fingerprint(runs["lockstep"])


def test_service_schedule_equals_the_reference_service(shipped_mode):
    mode, runs = shipped_mode
    assert_same_schedule(runs["service"], runs["ref"])
    if mode != "fallback":
        assert runs["service"].telemetry.refreshes == runs["ref"].telemetry.refreshes


@pytest.mark.parametrize("seed", [0, 7, 1234, 9999])
def test_replay_determinism_on_seeded_traces(seed):
    """Seeded arrival/drift traces replay bitwise — joules, misses,
    makespan AND per-job configs (the fingerprint holds them all)."""
    rng = np.random.default_rng(seed)
    n_jobs = int(rng.integers(4, 8))
    spacing = float(rng.uniform(60.0, 260.0))
    slack = float(rng.uniform(2.0, 4.0))
    jobs = trace(n_jobs, spacing=spacing, slack=slack)
    drift = [
        (
            float(rng.uniform(1.0, max(spacing * n_jobs, 2.0))),
            APPS[int(rng.integers(len(APPS)))],
            float(rng.uniform(1.2, 2.0)),
        )
    ]
    negotiate = bool(rng.integers(2))
    kw = dict(negotiate=negotiate)
    if negotiate and rng.integers(2):
        kw["lookahead"] = fleet.LookaheadPolicy(horizon_s=float(rng.uniform(300, 900)))
    lockstep = build_scheduler(**kw)
    lockstep.run(jobs, drift_events=drift)
    reactor = build_scheduler(**kw)
    SchedulerService(reactor).run(jobs, drift_events=drift)
    assert fingerprint(reactor) == fingerprint(lockstep)


# ---------------------------------------------------------------------------
# fault injection: zero lost jobs, honest ledger
# ---------------------------------------------------------------------------


def assert_zero_lost_and_honest(sched, n_jobs):
    done = sched.completed
    assert sorted(c.placement.job.job_id for c in done) == list(range(n_jobs))
    # the honest paper-units ledger: every job's _j total is its final
    # segment plus everything carried from killed/preempted segments, and
    # the fleet total is exactly their sum
    for c in done:
        assert c.total_energy_j == c.result.energy_j + c.prior_energy_j
        assert c.total_energy_j > 0
    assert math.isclose(
        sched.total_energy_j(), sum(c.total_energy_j for c in done)
    )


def run_with_fault(fault, path, *, build=build_scheduler, jobs=None, period_s=150.0):
    """The seeded fault on a journaled, heartbeating service; a torn
    commit restarts from the journal. Returns the scheduler that finished
    and whether the fault landed: the commit tore, the crashed node's
    segment was killed, or the silent node was declared down."""
    jobs = trace(6) if jobs is None else jobs
    sched = build(negotiate=True)
    svc = SchedulerService(sched, journal=path, heartbeat_period_s=period_s)
    faults.inject(svc, fault)
    try:
        svc.run(jobs)
    except JournalTorn:
        # the simulated death between snapshot and commit: restart from
        # the journal (which atomically kept the previous commit)
        sched = build(negotiate=True)
        svc = SchedulerService.resume(path, sched, heartbeat_period_s=period_s)
        svc.drain()
        return sched, True
    if fault.kind == "node-down":
        landed = any(p.from_node == fault.node for p in sched.telemetry.preemptions)
    else:
        landed = fault.kind == "heartbeat-loss" and not svc.managers[fault.node].available
    return sched, landed


@pytest.mark.parametrize(
    "kind,seed", [(k, s) for k, seeds in FAULT_SEEDS.items() for s in seeds])
def test_any_single_fault_ends_with_zero_lost_jobs(kind, seed, tmp_path):
    """One seeded fault — node crash, heartbeat loss, or a journal write
    torn between snapshot and commit — never loses a job and never breaks
    the energy ledger."""
    nodes = [n.name for n in build_scheduler().pool]
    fault = faults.single_fault_schedule(seed, nodes=nodes, t_lo_s=100.0, t_hi_s=900.0)
    assert fault.kind == kind
    sched, landed = run_with_fault(fault, str(tmp_path / f"fault-{seed}.json"))
    assert landed, fault
    assert_zero_lost_and_honest(sched, 6)


def test_node_down_kills_in_flight_and_requeues_honestly():
    """Deterministic in-flight kill: find the longest-running segment in
    a golden run, crash its node mid-segment, and check the job restarts
    elsewhere with the burned joules carried on its bill."""
    jobs = trace(8)
    golden = build_scheduler(negotiate=True)
    SchedulerService(golden).run(jobs)
    victim = max(golden.completed, key=lambda c: c.result.time_s)
    t_kill = victim.placement.start_s + 0.5 * victim.result.time_s
    node = victim.placement.node

    sched = build_scheduler(negotiate=True)
    svc = SchedulerService(sched)
    svc.inject(ev.node_down(t_kill, node))
    svc.inject(ev.node_up(t_kill + 500.0, node))
    svc.run(jobs)
    assert_zero_lost_and_honest(sched, len(jobs))
    jid = victim.placement.job.job_id
    restarted = next(c for c in sched.completed if c.placement.job.job_id == jid)
    assert restarted.restarts == 1
    assert restarted.placement.node != node  # replanned off the dead node
    assert restarted.prior_energy_j > 0  # the burned segment is on the bill
    rec = next(p for p in sched.telemetry.preemptions if p.job_id == jid)
    assert rec.from_node == node and rec.burned_j > 0
    assert rec.migration_cost_j == 0.0  # a crash is not a checkpoint
    # the dead node's reservation really was truncated at the crash
    dead = next(n for n in sched.pool if n.name == node)
    cut = [r for r in dead.reservations if r.job_id == jid]
    assert cut and max(r.end_s for r in cut) == pytest.approx(t_kill)


def test_heartbeat_loss_declares_node_down_and_recovers():
    jobs = trace(6)
    sched = build_scheduler(negotiate=True)
    svc = SchedulerService(sched, heartbeat_period_s=120.0)
    lost = sched.pool.nodes[1].name
    svc.managers[lost].silence_after_s = 200.0
    svc.run(jobs)
    assert_zero_lost_and_honest(sched, len(jobs))
    # the service *declared* the silent node down (the node never crashed)
    assert not svc.managers[lost].available
    late = [
        c
        for c in sched.completed
        if c.finish_s > 200.0 + 2.5 * 120.0 and c.placement.node == lost
    ]
    assert not late, "work was placed on a node the service cannot hear"


def test_artifact_jobs_refuse_the_journal(tmp_path):
    sched = build_scheduler()
    svc = SchedulerService(sched, journal=str(tmp_path / "j.json"))
    bad = fleet.Job(0, "raytrace", 1.0, deadline_s=100.0, terms=object())
    with pytest.raises(ValueError, match="artifact"):
        svc.submit(bad)


# ---------------------------------------------------------------------------
# the kill switch (the CLI's --kill-at)
# ---------------------------------------------------------------------------


def test_kill_at_raises_service_killed_with_resume_coordinates(tmp_path):
    jobs = trace(6)
    path = str(tmp_path / "killed.json")
    sched = build_scheduler()
    svc = SchedulerService(sched, journal=path, kill_at_s=300.0)
    with pytest.raises(ServiceKilled) as exc:
        svc.run(jobs)
    assert exc.value.journal_path == path
    assert exc.value.time_s is not None and exc.value.time_s > 300.0
    # the journal's last commit predates the kill: resumable state
    payload = Journal.load(path)
    assert payload["now_s"] <= 300.0 + 1e-6
    assert exc.value.n_batches == payload["n_batches"]


# ---------------------------------------------------------------------------
# nothing on the service path reads a wall clock
# ---------------------------------------------------------------------------

SIM_CLOCK = analysis_rules.RULES["sim-clock-purity"]


def _wall_clock_reads(src, path):
    """The port's repro-lint ``sim-clock-purity`` findings in ``src``, as
    if it lived at the repo-relative ``path``."""
    found, _ = analysis_core.analyze_source(src, path, [SIM_CLOCK])
    return found


SERVICE_DIR = os.path.join(REPO, "src", "repro_torch", "fleet", "service")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(SERVICE_DIR) if f.endswith(".py")))
def test_service_reads_no_wall_clock(name):
    rel = f"src/repro_torch/fleet/service/{name}"
    assert SIM_CLOCK.applies(rel)
    with open(os.path.join(REPO, rel)) as f:
        assert [x.render() for x in _wall_clock_reads(f.read(), rel)] == []


def test_wall_clock_check_sees_each_form():
    bad = ("import time, datetime\nfrom time import perf_counter\n"
           "a = time.monotonic()\nb = datetime.datetime.now()\nc = perf_counter()\n")
    found = _wall_clock_reads(bad, "src/repro_torch/fleet/service/bad.py")
    assert [(x.line, x.message.split("()")[0]) for x in found] == [
        (3, "wall-clock read time.monotonic"), (4, "wall-clock read datetime.datetime.now"),
        (5, "wall-clock read perf_counter")]
