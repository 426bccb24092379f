"""Crash recovery of the port's fleet service, and journals across packages.

The durability contract: a ``SchedulerService`` killed after a committed
batch and restarted from its journal (fresh scheduler, fresh engine on
``device="cpu"``) completes a schedule bitwise-identical to the
uninterrupted run, in the same number of batches. Two scenarios, as in
the reference's ``tests/test_service_recovery.py``: the lookahead
scenario (drift and horizon holds; kills land between the drift
observation and its refit) and the migration scenario (the eager
two-node rebalancer; kills land around a preemption).

Across packages the journal is one format: a journal the JAX package
wrote, killed at an early, a middle and a late batch, resumes under the
port to the reference's uninterrupted schedule (placements, starts,
finishes and joules equal; predicted energies within ``PRED_REL``), and
the port's own journal at the same kill point holds the reference's keys
and non-float values exactly and its floats within ``PRED_REL``: the
telemetry's predicted times and the refit's training targets carry the
SVR's last-bit differences.
"""

import json

import pytest

from repro.fleet import service as ref_service
from repro_torch.fleet.service import SchedulerService, ServiceKilled
from test_torch_service import (
    PRED_REL,
    PORT,
    QUICK_ENGINE_KW,
    QUICK_FREQS,
    REF,
    assert_same_schedule,
    fingerprint,
    trace,
)

# -- scenario builders (fresh scheduler per process incarnation) ------------


def _lookahead_scheduler(pkg):
    f = pkg.fleet
    pool = f.make_pool(3, seed=0)
    engine = f.fleet_engine(pool, **QUICK_ENGINE_KW, **pkg.engine_kw)
    return f.FleetScheduler(
        pool,
        engine,
        char_freqs=QUICK_FREQS[::2],
        char_cores=(1, 8, 16, 32),
        negotiator=f.Negotiator(pool, engine.power),
        lookahead=f.LookaheadPolicy(horizon_s=600.0),
    )


def _lookahead_jobs(pkg):
    jobs = trace(12, pkg=pkg, spacing=120.0, slack=2.5)
    drift = [(jobs[0].arrival_s + 1.0, jobs[0].app, 1.7)]
    return jobs, drift


def _migration_scheduler(pkg):
    # the eager two-node rebalancer scenario: the drift re-fit preempts an
    # in-flight job off the expensive node
    f = pkg.fleet
    specs = [
        f.NodeSpec("good-0"),
        f.NodeSpec(
            "bad-1",
            static_power_skew=1.5,
            dynamic_power_skew=1.4,
            speed_skew=1.3,
        ),
    ]
    pool = f.NodePool([f.FleetNode(s, seed=101 * i) for i, s in enumerate(specs)])
    engine = f.fleet_engine(pool, **QUICK_ENGINE_KW, **pkg.engine_kw)
    return f.FleetScheduler(
        pool,
        engine,
        char_freqs=QUICK_FREQS[::2],
        char_cores=(1, 8, 16, 32),
        migration=f.MigrationPolicy(
            cost_j=100.0,
            min_drift=0.10,
            min_remaining_frac=0.05,
            min_saving_frac=0.01,
        ),
    )


def _migration_jobs(pkg):
    Job = pkg.fleet.Job
    jobs = [
        Job(0, "blackscholes", 3.0, deadline_s=1e6, arrival_s=0.0),
        Job(1, "swaptions", 1.0, deadline_s=1e6, arrival_s=10.0),
        Job(2, "swaptions", 1.0, deadline_s=520.0, arrival_s=20.0),
        Job(3, "swaptions", 1.0, deadline_s=530.0, arrival_s=30.0),
        Job(4, "swaptions", 1.0, deadline_s=540.0, arrival_s=40.0),
    ]
    return jobs, [(15.0, "swaptions", 1.8)]


SCENARIOS = {
    "lookahead": (_lookahead_scheduler, _lookahead_jobs),
    "migration": (_migration_scheduler, _migration_jobs),
}


def _golden(pkg, name, path):
    """The uninterrupted run (with a journal, so batch timing matches the
    killed runs commit-for-commit)."""
    build, trace_fn = SCENARIOS[name]
    jobs, drift = trace_fn(pkg)
    sched = build(pkg)
    svc = pkg.service.SchedulerService(sched, journal=str(path))
    svc.run(jobs, drift_events=drift)
    return svc


def _kill(pkg, name, path, k):
    """Run the scenario under ``pkg`` and kill it before batch ``k``; the
    journal at ``path`` holds the last commit."""
    build, trace_fn = SCENARIOS[name]
    jobs, drift = trace_fn(pkg)
    svc = pkg.service.SchedulerService(build(pkg), journal=str(path), kill_after_batches=k)
    with pytest.raises(pkg.service.ServiceKilled):
        svc.run(jobs, drift_events=drift)


def _resume(name, path):
    """The restarted process: rebuilt port objects, journaled state."""
    fresh = SCENARIOS[name][0](PORT)
    resumed = SchedulerService.resume(str(path), fresh)
    assert resumed.recovered
    resumed.drain()
    return resumed


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def goldens(request, tmp_path_factory):
    """Each scenario's uninterrupted service run in both packages."""
    name = request.param
    d = tmp_path_factory.mktemp(name)
    return name, _golden(PORT, name, d / "port.json"), _golden(REF, name, d / "ref.json")


def _kill_points(n):
    return {"early": 0, "mid": n // 2, "late": n - 1}


def _assert_scenario_exercises_its_coverage(name, sched):
    if name == "lookahead":
        assert sched.telemetry.refreshes, "drift refit never fired"
        assert sum(r.n_tentative for r in sched.rounds) > 0, (
            "no tentative holds — the lookahead sweep is not covering them"
        )
    else:
        assert sched.telemetry.preemptions, "migration never fired"
        assert any(c.migrations > 0 for c in sched.completed)


def test_kill_early_mid_late_replays_bitwise(goldens, tmp_path):
    """Genesis commit, mid-run, and the final batch."""
    name, golden, _ = goldens
    _assert_scenario_exercises_its_coverage(name, golden.scheduler)
    n = golden.n_batches
    assert n > 3
    for where, k in _kill_points(n).items():
        path = tmp_path / f"kill-{k}.json"
        _kill(PORT, name, path, k)
        resumed = _resume(name, path)
        assert fingerprint(resumed.scheduler) == fingerprint(golden.scheduler), where
        assert resumed.n_batches == n, where


def test_port_service_equals_the_reference_service(goldens):
    name, golden, ref = goldens
    assert_same_schedule(golden.scheduler, ref.scheduler)
    assert golden.n_batches == ref.n_batches
    assert golden.scheduler.telemetry.refreshes == ref.scheduler.telemetry.refreshes


def test_reference_journal_resumes_under_the_port(goldens, tmp_path):
    """A journal the JAX package wrote, killed early, mid and late,
    drains under the port to the reference's uninterrupted schedule."""
    name, _, ref = goldens
    n = ref.n_batches
    for where, k in _kill_points(n).items():
        path = tmp_path / f"ref-kill-{k}.json"
        _kill(REF, name, path, k)
        resumed = _resume(name, path)
        assert_same_schedule(resumed.scheduler, ref.scheduler)
        assert resumed.n_batches == n, where


def _diff_documents(mine, theirs, where="$"):
    """Every place two JSON documents part: keys, types and non-float
    values exactly; floats within PRED_REL (relative, 1e-9 absolute near
    zero). Returns the largest relative float gap."""
    assert type(mine) is type(theirs) or {type(mine), type(theirs)} <= {int, float}, where
    if isinstance(mine, dict):
        assert sorted(mine) == sorted(theirs), where
        return max([0.0] + [_diff_documents(mine[k], theirs[k], f"{where}.{k}") for k in mine])
    if isinstance(mine, list):
        assert len(mine) == len(theirs), where
        return max([0.0] + [_diff_documents(a, b, f"{where}[{i}]")
                            for i, (a, b) in enumerate(zip(mine, theirs))])
    if isinstance(mine, float) or isinstance(theirs, float):
        gap = abs(mine - theirs)
        rel = gap / max(abs(theirs), 1e-300)
        assert gap <= 1e-9 or rel <= PRED_REL, (where, mine, theirs)
        return 0.0 if gap == 0 else rel
    assert mine == theirs, where
    return 0.0


def test_port_journal_has_the_reference_wire_format(goldens, tmp_path):
    name, golden, _ = goldens
    for where, k in _kill_points(golden.n_batches).items():
        _kill(PORT, name, tmp_path / f"port-{k}.json", k)
        _kill(REF, name, tmp_path / f"ref-{k}.json", k)
        mine = json.loads((tmp_path / f"port-{k}.json").read_text())
        theirs = json.loads((tmp_path / f"ref-{k}.json").read_text())
        _diff_documents(mine, theirs)
        # the journal loads in the other package
        assert ref_service.Journal.load(str(tmp_path / f"port-{k}.json")) == mine
    # the belief records carry the refit's training sets in float32
    last = json.loads((tmp_path / f"port-{golden.n_batches - 1}.json").read_text())
    beliefs = last["ledger"]["beliefs"]
    assert beliefs and all(b["x"]["dtype"] == b["y"]["dtype"] == "float32" for b in beliefs)


def test_recovery_restores_half_detected_drift(tmp_path):
    """Kill BETWEEN the drift observation and the refit it will trigger.
    The detector's sliding windows live only in ``TelemetryHub`` — if the
    journal dropped them, the resumed run would never refresh and the
    schedule would silently diverge from golden."""
    golden = _golden(PORT, "lookahead", tmp_path / "golden.json")
    sched_g = golden.scheduler
    assert sched_g.telemetry.refreshes
    t_refresh = sched_g.telemetry.refreshes[0][0]

    build, trace_fn = SCENARIOS["lookahead"]
    jobs, drift = trace_fn(PORT)
    path = str(tmp_path / "half-detected.json")
    # dies on the refresh batch itself: the last commit holds observed
    # errors that have NOT yet triggered the refit
    svc = SchedulerService(build(PORT), journal=path, kill_at_s=t_refresh - 1e-6)
    with pytest.raises(ServiceKilled):
        svc.run(jobs, drift_events=drift)

    fresh = build(PORT)
    resumed = SchedulerService.resume(path, fresh)
    assert any(fresh.telemetry.detector._errors.values()), (
        "journal dropped the drift detector's windows — the half-detected "
        "drift was forgotten"
    )
    resumed.drain()
    assert fresh.telemetry.refreshes == sched_g.telemetry.refreshes
    assert fingerprint(fresh) == fingerprint(sched_g)


# ---------------------------------------------------------------------------
# the committed goldens chip_smoke.py resumes on the card
# ---------------------------------------------------------------------------


def test_committed_service_goldens_equal_the_live_reference():
    from helpers import make_torch_port_service_golden as gold

    with open(gold.JOURNAL) as f:
        assert json.load(f) == gold.killed_journal()
    with open(gold.GOLDEN) as f:
        committed = json.load(f)
    live = json.loads(json.dumps(gold.service_record()))
    assert {k: v for k, v in committed.items() if k != "source"} == live


def test_committed_reference_journal_resumes_under_the_port_cli(tmp_path):
    """``python -m repro_torch.fleet --resume F --device cpu`` on the JAX
    package's killed ``--quick --service`` journal drains to the
    reference's uninterrupted schedule."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from helpers import make_torch_port_service_golden as gold
    from repro_torch.fleet import __main__ as port_main

    path = str(tmp_path / "journal.json")
    shutil.copy(gold.JOURNAL, path)
    with open(gold.GOLDEN) as f:
        want = json.load(f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sched = port_main.main(["--resume", path, "--device", "cpu"])
    assert gold.job_rows(sched) == want["jobs"]
    np.testing.assert_allclose(
        [c.placement.predicted_energy_j for c in sched.completed],
        want["predicted_energy_j"], rtol=PRED_REL, atol=0)
    assert sched.total_energy_j() == want["total_energy_j"]
    assert f"{want['n_batches']} batches total" in buf.getvalue()
    assert sched.telemetry.n_recharacterizations >= 1  # the drift refit, after the resume
