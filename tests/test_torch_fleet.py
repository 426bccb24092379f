"""The fleet on the port against the live JAX package, on the host.

Units (the node pool, the reservation ledger, ``CapacityProfile``,
``time_eps``, the Negotiator's projection and options, the drift detector)
must equal the reference's exactly. A round must issue one ``plan_many``
(cheapest-first) or one ``pareto_many`` (negotiated, lookahead). The
schedules of ``python -m repro_torch.fleet --quick`` and two of its
variants run both packages on the reference's fitted power coefficients,
so that the fleet code alone is compared: the completed jobs and the
report's ``to_json()`` must be identical but for the plans' predicted
energies, which carry the SVR's last-bit differences (``PRED_REL``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from helpers.make_torch_port_fleet_golden import job_rows, run_captured
from repro.core.power import PowerModel as RefPowerModel
from repro.fleet import __main__ as ref_main
from repro.fleet import cluster as ref_cluster
from repro.fleet import negotiate as ref_negotiate
from repro.fleet import scheduler as ref_scheduler
from repro.fleet import telemetry as ref_telemetry
from repro_torch.core.engine import ParetoPoint
from repro_torch.core.node_sim import F_MAX, FREQ_GRID, PROFILES
from repro_torch.core.power import PowerModel
from repro_torch.fleet import __main__ as port_main
from repro_torch.fleet import cluster, negotiate, scheduler, telemetry
from repro_torch.fleet.negotiate import NegotiationResult, Negotiator

CPU = "cpu"
QUICK_FREQS = tuple(float(f) for f in FREQ_GRID[::3])
QUICK_CORES = (1, 2, 4, 8, 16, 24, 32)
QUICK_ENGINE_KW = dict(freqs=QUICK_FREQS, cores=QUICK_CORES, noise=0.01, seed=0)
# plan energies predicted by the SVR: the port's fits differ from the
# reference's in the last bits of the Gram (ROADMAP §C), up to 1.4e-4
# relative over the four golden runs
PRED_REL = 5e-4
COEFFS = (6.0, 2.0, 25.0, 11.0)


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _run_fields(r):
    """A RunResult as plain values (its traces as lists)."""
    return {k: np.asarray(v).tolist() for k, v in dataclasses.asdict(r).items()}


# ---------------------------------------------------------------------------
# cluster: specs, projection, nodes, the ledger
# ---------------------------------------------------------------------------


def _specs(mod):
    return [
        mod.NodeSpec("ref", max_cores=32),
        mod.NodeSpec("slow", max_cores=16, freq_table=(1.2, 1.7),
                     static_power_skew=0.9, dynamic_power_skew=1.1, speed_skew=1.15),
        mod.NodeSpec("eff", max_cores=8, freq_table=(0.8, 1.2, 2.2),
                     static_power_skew=0.7, dynamic_power_skew=0.85, speed_skew=1.05),
        mod.NodeSpec("v5e", max_cores=512, freq_table=cluster.TPU_FREQS, device="tpu",
                     cores_per_socket=256, static_power_skew=1.1),
    ]


def test_node_spec_projection_matches_reference():
    pm, rpm = PowerModel(*COEFFS), RefPowerModel(*COEFFS)
    terms, rterms = cluster.family_key("raytrace", 2.0), ref_cluster.family_key("raytrace", 2.0)
    for spec, rspec in zip(_specs(cluster), _specs(ref_cluster)):
        assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
        assert spec.truth_coeffs() == rspec.truth_coeffs()
        for f in (0.7, 1.2, 1.45, 1.7, 2.3):
            assert spec.snap_frequency(f) == rspec.snap_frequency(f)
            for p in (1, 3, 8, 16, 300):
                assert spec.sockets(p) == rspec.sockets(p)
                assert spec.expected_power(pm, f, p) == rspec.expected_power(rpm, f, p)
                assert spec.expected_energy(pm, f, p, 12.5) == rspec.expected_energy(
                    rpm, f, p, 12.5)
                assert cluster.project_point(spec, pm, terms, p, f, 40.0) == (
                    ref_cluster.project_point(rspec, rpm, rterms, p, f, 40.0))


def test_pools_match_reference():
    for mine, theirs in ((cluster.make_pool(6, seed=3), ref_cluster.make_pool(6, seed=3)),
                         (cluster.make_mixed_pool(3, 2, seed=1),
                          ref_cluster.make_mixed_pool(3, 2, seed=1))):
        assert [dataclasses.asdict(n.spec) for n in mine] == [
            dataclasses.asdict(n.spec) for n in theirs]
        assert mine.devices() == theirs.devices()
        assert mine.reference.name == theirs.reference.name
        for dev in mine.devices():
            assert mine.reference_for(dev).name == theirs.reference_for(dev).name


def test_fleet_node_runs_match_reference():
    from repro.core.evaluate import make_governor as ref_governor
    from repro_torch.core.evaluate import make_governor

    for i, (spec, rspec) in enumerate(zip(_specs(cluster)[:3], _specs(ref_cluster)[:3])):
        node, rnode = cluster.FleetNode(spec, seed=5 + i), ref_cluster.FleetNode(rspec, seed=5 + i)
        node.apply_drift("raytrace", 1.5)
        rnode.apply_drift("raytrace", 1.5)
        for app in sorted(PROFILES):
            f = spec.freq_table[len(spec.freq_table) // 2]
            assert _run_fields(node.run_fixed(app, f, 8, 2.0)) == _run_fields(
                rnode.run_fixed(app, f, 8, 2.0))
            gov, rgov = (make_governor("ondemand", spec.freq_table),
                         ref_governor("ondemand", spec.freq_table))
            assert _run_fields(node.run_governor(app, gov, 4, 1.0)) == _run_fields(
                rnode.run_governor(app, rgov, 4, 1.0))
        assert node.time_scale("raytrace") == rnode.time_scale("raytrace")
        fs, ps, ss, ws = node.stress_grid(QUICK_FREQS, (1, 8, 16))
        rfs, rps, rss, rws = rnode.stress_grid(QUICK_FREQS, (1, 8, 16))
        for a, b in ((fs, rfs), (ps, rps), (ss, rss), (ws, rws)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reservation_ledger_matches_reference(seed):
    """A seeded script of reservations, confirmations, releases and
    truncations, with every capacity query after each step."""
    rng = np.random.default_rng(seed)
    mine = cluster.NodePool([cluster.FleetNode(cluster.NodeSpec(f"n{i}", max_cores=32))
                             for i in range(3)])
    theirs = ref_cluster.NodePool([ref_cluster.FleetNode(ref_cluster.NodeSpec(
        f"n{i}", max_cores=32)) for i in range(3)])
    t = 0.0
    for step in range(60):
        i = int(rng.integers(3))
        op = int(rng.integers(5))
        start = t + float(rng.uniform(0.0, 200.0)) * int(rng.integers(2))
        end = start + float(rng.uniform(1e-3, 300.0))
        cores = int(rng.integers(1, 12))
        job = int(rng.integers(20))
        for pool in (mine, theirs):
            node = pool[i]
            if op == 0 or op == 1:
                node.reserve(start, end, cores, job_id=job, tentative=op == 1)
            elif op == 2:
                node.confirm_reservations(job)
            elif op == 3:
                pool.release_tentative(job if step % 2 else None)
            else:
                node.truncate_reservation(job, t + 50.0)
        q = t + float(rng.uniform(0.0, 400.0))

        def view(pool):
            return [
                [n.free_cores(q), n.free_cores(q, q + 100.0),
                 n.free_cores(q, include_tentative=False), n.earliest_gap(q, 80.0, 16),
                 n.utilization(q + 500.0), n.capacity_profile().valid()]
                for n in pool
            ] + [pool.max_free_cores(q), pool.next_completion(q), pool.utilization(q + 500.0)]

        assert view(mine) == view(theirs), step
        t += float(rng.uniform(0.0, 60.0))


def test_capacity_profile_and_time_eps_match_reference():
    for t in (0.0, 1e-12, 0.5, 3.0, 1e6, 1e7 + 0.125, -4.0):
        assert cluster.time_eps(t) == ref_cluster.time_eps(t)
        for s, e in ((0.0, 1.0), (t, t + 1e-3), (t - 5.0, t), (t, t)):
            eps = cluster.time_eps(t)
            assert cluster.segment_active_at(s, e, t, eps) == ref_cluster.segment_active_at(
                s, e, t, eps)
    rng = np.random.default_rng(11)
    mine, theirs = cluster.CapacityProfile(32), ref_cluster.CapacityProfile(32)
    for _ in range(40):
        s = float(rng.uniform(0.0, 1e7))
        e = s + float(rng.choice([1e-3, 5.0, 400.0]))
        c = int(rng.integers(1, 20))
        mine.add(s, e, c)
        theirs.add(s, e, c)
        q = float(rng.uniform(0.0, 1e7))
        assert mine.busy_at(q) == theirs.busy_at(q)
        assert mine.free_over(q, q + 300.0) == theirs.free_over(q, q + 300.0)
        assert mine.has_capacity(q, q + 50.0, 8) == theirs.has_capacity(q, q + 50.0, 8)
        assert mine.earliest_gap(q, 60.0, 16) == theirs.earliest_gap(q, 60.0, 16)
        assert mine.gap_candidates(q) == theirs.gap_candidates(q)
        assert mine.valid() == theirs.valid()


# ---------------------------------------------------------------------------
# negotiation: the vectorized projection, options and the search
# ---------------------------------------------------------------------------


def _hetero(mod, pm_cls):
    specs = _specs(mod)[:3]
    pool = mod.NodePool([mod.FleetNode(s, seed=i) for i, s in enumerate(specs)])
    return pool, specs, pm_cls(*COEFFS)


def _frontier(point_cls, terms):
    return [point_cls(frequency_ghz=f, chips=c, pods=1, step_time_s=terms.step_time(f, c),
                      power_w=0.0, energy_per_step_j=0.0)
            for f in (1.2, 1.7, 2.2) for c in (2, 4, 8, 16)]


def test_project_grid_matches_project_point_and_reference():
    from repro.core.engine import ParetoPoint as RefParetoPoint

    pool, specs, pm = _hetero(cluster, PowerModel)
    rpool, _, rpm = _hetero(ref_cluster, RefPowerModel)
    terms = cluster.family_key("raytrace", 1.0)
    frontier = _frontier(ParetoPoint, terms)
    got = Negotiator(pool, pm)._project_grid(terms, frontier)
    want = ref_negotiate.Negotiator(rpool, rpm)._project_grid(
        ref_cluster.family_key("raytrace", 1.0),
        _frontier(RefParetoPoint, ref_cluster.family_key("raytrace", 1.0)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k, pt in enumerate(frontier):
        for m, spec in enumerate(specs):
            fs, t, e = cluster.project_point(spec, pm, terms, pt.chips, pt.frequency_ghz,
                                             pt.step_time_s)
            assert (got[0][k, m], got[1][k, m], got[2][k, m]) == (fs, t, e)


def test_negotiator_options_and_search_match_reference():
    from repro.core.engine import ParetoPoint as RefParetoPoint

    pool, specs, pm = _hetero(cluster, PowerModel)
    rpool, _, rpm = _hetero(ref_cluster, RefPowerModel)
    neg, rneg = Negotiator(pool, pm), ref_negotiate.Negotiator(rpool, rpm)
    terms, rterms = cluster.family_key("raytrace", 1.0), ref_cluster.family_key("raytrace", 1.0)
    frontier = _frontier(ParetoPoint, terms)
    slack = float(terms.step_time(1.7, 8)) * 1.1
    got = neg._options(terms, frontier, [32, 6, 8], slack)
    want = []  # the per-pair scalar enumeration
    for k, pt in enumerate(frontier):
        for m, node in enumerate(pool):
            if pt.chips > [32, 6, 8][m]:
                continue
            fs, t, e = cluster.project_point(node.spec, pm, terms, pt.chips,
                                             pt.frequency_ghz, pt.step_time_s)
            want.append(negotiate.Option(point_idx=k, node_idx=m, cores=pt.chips,
                                         frequency_ghz=fs, time_s=t, energy_j=e,
                                         meets_deadline=slack > 0 and t <= slack))
    assert got == want
    assert [_asdict(o) for o in got] == [_asdict(o) for o in rneg._options(
        rterms, _frontier(RefParetoPoint, rterms), [32, 6, 8], slack)]
    # random contention: the joint search and its seed, option for option
    rng = np.random.default_rng(7)
    for trial in range(25):
        n_jobs = int(rng.integers(1, 7))
        jobs, rjobs, fronts, rfronts, slacks = [], [], [], [], []
        for i in range(n_jobs):
            slack = float(rng.uniform(50.0, 1500.0))
            jobs.append(scheduler.Job(i, "swaptions", 1.0, deadline_s=slack))
            rjobs.append(ref_scheduler.Job(i, "swaptions", 1.0, deadline_s=slack))
            pts = [(float(rng.choice((1.2, 1.7, 2.2))), int(rng.choice((1, 2, 4, 8))), float(t))
                   for t in np.sort(rng.uniform(40.0, 1200.0, size=int(rng.integers(1, 4))))]
            fronts.append([ParetoPoint(f, c, 1, t, 0.0, 0.0) for f, c, t in pts])
            rfronts.append([RefParetoPoint(f, c, 1, t, 0.0, 0.0) for f, c, t in pts])
            slacks.append(slack)
        free = [int(rng.integers(0, 9)), int(rng.integers(0, 5)), int(rng.integers(0, 9))]
        got = neg.negotiate(jobs, [terms] * n_jobs, fronts, free, slacks)
        want = rneg.negotiate(rjobs, [rterms] * n_jobs, rfronts, free, slacks)
        for a, b in ((got.assignments, want.assignments), (got.seed, want.seed)):
            assert [_asdict(o) for o in a] == [_asdict(o) for o in b], trial
        assert (got.n_moves, got.n_exchanges) == (want.n_moves, want.n_exchanges)
        assert NegotiationResult.projected(got.assignments) <= NegotiationResult.projected(
            got.seed)


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_drift_detector_and_hub_match_reference():
    rng = np.random.default_rng(3)
    mine, theirs = telemetry.TelemetryHub(), ref_telemetry.TelemetryHub()
    fams = [("raytrace", 1.0), ("swaptions", 2.0), ("blackscholes", 1.0)]
    for i in range(60):
        fam = fams[int(rng.integers(3))]
        kw = dict(family=fam, node="ref-0", frequency_ghz=2.0, cores=8, input_size=fam[1],
                  predicted_time_s=100.0, measured_time_s=100.0 * float(rng.uniform(0.8, 1.7)),
                  predicted_energy_j=1e4, measured_energy_j=1e4, finish_s=10.0 * i)
        mine.record(telemetry.Observation(**kw))
        theirs.record(ref_telemetry.Observation(**kw))
        assert mine.stale_families() == theirs.stale_families()
        for f in fams:
            assert mine.detector.mean_error(f) == theirs.detector.mean_error(f)
            assert mine.detector.occupancy(f) == theirs.detector.occupancy(f)
        if i % 7 == 6:
            for f in mine.stale_families():
                mine.mark_refreshed(f, 10.0 * i)
                theirs.mark_refreshed(f, 10.0 * i)
        assert mine.silent_families(10.0 * i, 50.0) == theirs.silent_families(10.0 * i, 50.0)
    assert json.dumps(mine.to_json(), sort_keys=True) == json.dumps(
        theirs.to_json(), sort_keys=True)
    back = telemetry.TelemetryHub.from_json(json.loads(json.dumps(theirs.to_json())))
    assert back.to_json() == mine.to_json()


# ---------------------------------------------------------------------------
# one round: one batched engine pass
# ---------------------------------------------------------------------------


def _trace(n_jobs, *, spacing=150.0, slack=3.0):
    apps = sorted(PROFILES)
    return [scheduler.Job(i, apps[i % len(apps)], 1.0,
                          deadline_s=i * spacing + PROFILES[apps[i % len(apps)]].time(
                              F_MAX, 16, 1.0) * slack,
                          arrival_s=i * spacing)
            for i in range(n_jobs)]


@pytest.mark.parametrize("mode", ["cheapest-first", "negotiated", "lookahead"])
def test_one_batched_engine_pass_a_round(mode, monkeypatch):
    pool = cluster.make_pool(4, seed=0)
    engine = scheduler.fleet_engine(pool, device=CPU, **QUICK_ENGINE_KW)
    kw = {}
    if mode != "cheapest-first":
        kw["negotiator"] = Negotiator(pool, engine.power)
    if mode == "lookahead":
        kw["lookahead"] = scheduler.LookaheadPolicy(horizon_s=600.0)
    sched = scheduler.FleetScheduler(pool, engine, char_freqs=QUICK_FREQS[::2],
                                     char_cores=(1, 8, 16, 32), **kw)
    calls = {"plan_many": [], "pareto_many": []}
    for name in calls:
        inner = getattr(engine, name)

        def counted(ws, _inner=inner, _name=name):
            ws = list(ws)
            calls[_name].append(len(ws))
            return _inner(ws)

        monkeypatch.setattr(engine, name, counted)
    sched.run(_trace(6, spacing=120.0))
    planned = [r for r in sched.rounds if r.planned]
    one = "plan_many" if mode == "cheapest-first" else "pareto_many"
    assert calls[one] == [r.n_pending + r.n_future for r in planned]
    assert calls["pareto_many" if one == "plan_many" else "plan_many"] == []
    assert len(sched.completed) == 6
    assert engine.device == torch.device(CPU)


def test_refit_runs_on_the_engine_device(monkeypatch):
    from repro_torch.core import svr

    pool = cluster.make_pool(4, seed=0)
    engine = scheduler.fleet_engine(pool, device=CPU, **QUICK_ENGINE_KW)
    sched = scheduler.FleetScheduler(pool, engine, char_freqs=QUICK_FREQS[::2],
                                     char_cores=(1, 8, 16, 32))
    devices = []
    inner = svr.fit_many

    def counted(sets, **kw):
        devices.append(kw.get("device"))
        return inner(sets, **kw)

    monkeypatch.setattr(svr, "fit_many", counted)
    sched.run(_trace(10, spacing=140.0, slack=4.0), drift_events=[(300.0, "raytrace", 1.7)])
    assert sched.telemetry.n_recharacterizations >= 1
    assert devices and all(torch.device(d) == torch.device(CPU) for d in devices)
    terms = engine.cached_terms(cluster.family_key("raytrace", 1.0))
    assert terms.source == "telemetry" and terms.time_scale > 1.3


# ---------------------------------------------------------------------------
# schedules on the reference's power coefficients
# ---------------------------------------------------------------------------


def _ref_power(argv):
    quick = "--quick" in argv
    kw = ref_main._grids(quick, 0)[0]
    return ref_scheduler.fleet_engine(ref_cluster.make_pool(4, seed=0), **kw).power


def _with_power(module, power):
    """``module.run_fleet_comparison`` with ``power_model`` injected into
    every engine it builds; returns the restore function."""
    inner = module.run_fleet_comparison

    def comparison(*args, **kw):
        kw["engine_kw"] = dict(kw["engine_kw"], power_model=power)
        return inner(*args, **kw)

    module.run_fleet_comparison = comparison
    return lambda: setattr(module, "run_fleet_comparison", inner)


SCHEDULE_RUNS = {
    "quick": ["--quick"],
    "horizon-burst": ["--quick", "--horizon", "600", "--burst", "3"],
    "fallback": ["--quick", "--fallback"],
}


@pytest.fixture(scope="module", params=sorted(SCHEDULE_RUNS))
def injected_runs(request):
    argv = SCHEDULE_RUNS[request.param]
    rp = _ref_power(argv)
    pm = PowerModel(float(rp.c1), float(rp.c2), float(rp.c3), float(rp.c4))
    out = {}
    for key, module, power, extra in (("ref", ref_main, rp, []),
                                      ("port", port_main, pm, ["--device", CPU])):
        restore = _with_power(module, power)
        try:
            out[key] = run_captured(module, argv + extra)
        finally:
            restore()
    return request.param, out


def test_schedule_on_reference_power_is_identical(injected_runs):
    name, runs = injected_runs
    (ref_report, ref_sched), (report, sched) = runs["ref"], runs["port"]
    assert job_rows(sched) == job_rows(ref_sched), name
    assert len(sched.completed) == 12
    assert [r.planned for r in sched.rounds] == [r.planned for r in ref_sched.rounds]
    assert sched.telemetry.n_recharacterizations == ref_sched.telemetry.n_recharacterizations
    got, want = report.to_json(), ref_report.to_json()
    pred = [p.pop("predicted_energy_j") for p in got["comparison"]["plans"]]
    ref_pred = [p.pop("predicted_energy_j") for p in want["comparison"]["plans"]]
    assert json.dumps(got, sort_keys=True, default=float) == json.dumps(
        want, sort_keys=True, default=float)
    np.testing.assert_allclose(pred, ref_pred, rtol=PRED_REL, atol=0)
    # the JSON round trip of the port's report
    back = port_main.FleetReport.from_json(json.loads(json.dumps(report.to_json(), default=float)))
    assert back.to_json() == json.loads(json.dumps(report.to_json(), default=float))
