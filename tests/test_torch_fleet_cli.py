"""``python -m repro_torch.fleet`` against the live JAX package, on the host.

Each package fits its own power model and SVR surfaces here, as a user's
run does; the power fits differ by up to ~1e-5 relative (ROADMAP §C). On
the three ``--quick`` runs the schedules come out identical, not a
near-tie: the printed report table, every completed job and every
scenario. The committed golden that ``chip_smoke.py`` holds the card to
must equal the live reference's runs, so it cannot go stale. Also: the
artifact intake (``workloads_from_artifacts``, ``--artifacts``), a mixed
CPU + TPU pool with explicit TPU terms, ``--trace`` with ``python -m
repro_torch.obs``, the planner, the service flags (``--service``,
``--journal``, ``--kill-at``, ``--resume``) against the reference CLI's
printed lines, the entry points that are not ported, and
``chip_smoke.py``'s golden check of a fleet run, run on the host.
"""

import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from helpers.make_torch_port_fleet_golden import (
    OUT as GOLDEN,
    job_rows,
    run_captured,
    run_record,
)
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core import characterize as ref_characterize
from repro.core import engine as ref_engine
from repro.core import planner as ref_planner
from repro.fleet import __main__ as ref_main
from repro.fleet import cluster as ref_cluster
from repro.fleet import report as ref_report
from repro.fleet import scheduler as ref_scheduler
from repro_torch import obs
from repro_torch.configs.base import SHAPES
from repro_torch.core import characterize, engine, planner
from repro_torch.core.power import PowerModel
from repro_torch.fleet import __main__ as port_main
from repro_torch.fleet import cluster, report, scheduler
from repro_torch.obs.__main__ import main as obs_main

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# plans' predicted energies carry the SVR's last-bit differences
PRED_REL = 5e-4
QUICK_RUNS = {
    "quick": ["--quick"],
    "horizon-burst": ["--quick", "--horizon", "600", "--burst", "3"],
    "fallback": ["--quick", "--fallback"],
}


def _printed(module, argv):
    """``run_captured(module, argv)`` and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep, sched = run_captured(module, argv)
    return rep, sched, buf.getvalue()


@pytest.fixture(scope="module", params=sorted(QUICK_RUNS))
def own_fit_runs(request):
    argv = QUICK_RUNS[request.param]
    return (argv, _printed(ref_main, argv), _printed(port_main, argv + ["--device", CPU]))


def _strip_predicted(doc):
    pred = [p.pop("predicted_energy_j") for p in doc["comparison"]["plans"]]
    return json.dumps(doc, sort_keys=True, default=float), pred


def test_own_fits_give_identical_schedules(own_fit_runs):
    argv, (ref_rep, ref_sched, ref_out), (rep, sched, out) = own_fit_runs
    # identical, not a near-tie: every completed job, the table as printed
    assert job_rows(sched) == job_rows(ref_sched), argv
    assert out == ref_out
    assert "engine <= every baseline fleet (tol 5%): True" in out
    got, pred = _strip_predicted(rep.to_json())
    want, ref_pred = _strip_predicted(ref_rep.to_json())
    assert got == want
    np.testing.assert_allclose(pred, ref_pred, rtol=PRED_REL, atol=0)


def test_golden_equals_the_live_reference(own_fit_runs):
    argv, (ref_rep, ref_sched, _), (rep, sched, _) = own_fit_runs
    with open(GOLDEN) as f:
        golden = json.load(f)
    gold = next(r for r in golden["runs"] if r["argv"] == argv)
    live = json.loads(json.dumps(dict(argv=argv, **run_record(ref_rep, ref_sched))))
    assert live == gold
    # and the port on the host, as chip_smoke.py holds the card
    mine = json.loads(json.dumps(run_record(rep, sched)))
    for key in ("jobs", "scenarios", "refits", "migrations"):
        assert mine[key] == gold[key], key
    assert [r["argv"] for r in golden["runs"]] == [
        [], ["--quick"], ["--quick", "--horizon", "600", "--burst", "3"],
        ["--quick", "--fallback"]]


# ---------------------------------------------------------------------------
# chip_smoke.py's golden check, on the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """A private copy of ``chip_smoke.py`` whose runs take the host."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.DEVICE = CPU
    return module


@pytest.fixture(scope="module")
def smoke_quick(smoke):
    with open(GOLDEN) as f:
        gold = next(r for r in json.load(f)["runs"] if r["argv"] == ["--quick"])
    with contextlib.redirect_stdout(io.StringIO()):
        rep, sched, surfaces = smoke._fleet_sim_run(gold["argv"])
    return gold, rep, sched, surfaces


def test_smoke_fleet_check_passes_the_port_and_refuses_the_control(smoke, smoke_quick, capsys):
    gold, rep, sched, surfaces = smoke_quick
    tie, pred_rel = smoke._check_fleet_run(torch, np, gold, rep, sched, surfaces)
    assert tie is None and 0 < pred_rel <= smoke.FLEET_PRED_REL
    # a Gram rounded to CONTROL_BITS bits keeps the placements, not the
    # predictions; the phase raises if the check lets it through
    smoke.phase_fleet_control(torch, np)
    assert "refused" in capsys.readouterr().out


def test_smoke_fleet_check_finds_the_first_divergence_in_launch_order(
        smoke, smoke_quick, monkeypatch, capsys):
    """A job placed otherwise, and a job launched after it that completes
    first with the same placement and a later start: the first divergence
    in launch order is the first job's placement."""
    gold, rep, sched, surfaces = smoke_quick
    jobs = copy.deepcopy(gold["jobs"])
    done = {r[0]: i for i, r in enumerate(jobs)}
    a, b = next((a, b) for a in jobs for b in jobs if a[4] < b[4] and done[b[0]] < done[a[0]])
    a[3] += 1  # cores
    b[4] += 1e-3  # start
    moved = dict(gold, jobs=jobs)
    monkeypatch.setattr(smoke, "NEAR_TIE_REL", 1.0)
    tie, _ = smoke._check_fleet_run(torch, np, moved, rep, sched, surfaces)
    assert tie is not None and f"job {a[0]} " in tie
    assert "[near-tie]" in capsys.readouterr().out
    monkeypatch.setattr(smoke, "NEAR_TIE_REL", 0.0)
    with pytest.raises(AssertionError, match="placement differs from the golden"):
        smoke._check_fleet_run(torch, np, moved, rep, sched, surfaces)


def test_smoke_service_phase_on_the_host(smoke, smoke_quick, monkeypatch, tmp_path, capsys):
    """Phase 5c on the host, at the ``--quick`` run: the service against
    the lockstep run, kills and resumes, the JAX package's journal, the
    faults, fit_many's batches and the apps (native sizes cut to the
    host's); a lockstep schedule moved by one joule is refused."""
    _, _, sched, _ = smoke_quick
    monkeypatch.setattr(smoke, "SERVICE_RUNS", (["--quick"],))
    monkeypatch.setattr(smoke, "SERVICE_DIR", str(tmp_path))
    monkeypatch.setattr(smoke, "APPS_NATIVE_N", {"blackscholes": 10_000, "swaptions": 4,
                                                 "raytrace": 32, "fluidanimate": 216})
    lockstep = {("--quick",): smoke._fleet_schedule(sched)}
    walls, pred_rel = smoke.phase_service(torch, np, "host", lockstep)
    assert set(walls) == {"--quick"} and 0 < pred_rel <= smoke.FLEET_PRED_REL
    smoke.phase_service_faults(torch, np, "host")
    smoke.phase_service_batches(torch, np)
    smoke.phase_apps(torch, np, "host")
    out = capsys.readouterr().out
    assert out.count("bit for bit") == 5 and out.count("[apps]") == 8
    assert "equal to the JAX package's uninterrupted run" in out
    moved = copy.deepcopy(lockstep)
    moved[("--quick",)]["jobs"][0][6] += 1.0
    with pytest.raises(AssertionError, match="differs from phase 5b's lockstep run"):
        smoke._service_runs(torch, "host", moved)


def test_smoke_mixed_phase_on_the_host(smoke, monkeypatch, tmp_path, capsys):
    """Phase 5d on the host: ``--quick --mixed`` against the golden, the
    service run, its kill at the golden's kill point and resume, and
    ``launch.train --auto-energy``'s plan against the reference's; a
    golden moved by one joule is refused."""
    monkeypatch.setattr(smoke, "SERVICE_DIR", str(tmp_path))
    pred_rel = smoke.phase_mixed(torch, np, "host")
    assert 0 < pred_rel <= smoke.FLEET_PRED_REL
    out = capsys.readouterr().out
    assert out.count("bit for bit") == 3 and "equal to the JAX package's plan" in out
    assert "4 of 12 jobs are the zoo's TPU workloads" in out
    with open(GOLDEN) as f:
        golden = json.load(f)
    golden["mixed"]["service"]["total_energy_j"] += 1.0
    moved = tmp_path / "moved.json"
    moved.write_text(json.dumps(golden))
    monkeypatch.setattr(smoke, "FLEET_GOLDEN", str(moved))
    with pytest.raises(AssertionError, match="golden"):
        smoke.phase_mixed(torch, np, "host")


# ---------------------------------------------------------------------------
# artifact intake
# ---------------------------------------------------------------------------


def _write_artifacts(dirpath):
    for arch, flops, shape in (("gem", 2e15, "train_4k"), ("qwn", 5e15, "prefill_32k"),
                               ("mmb", 8e14, "train_4k"), ("old", 3e15, "renamed_1k")):
        rec = {"ok": True, "hlo": {"flops_per_device": flops,
                                   "memory_bytes_per_device": 1e12,
                                   "collective_bytes_per_device": 2e11}}
        with open(os.path.join(dirpath, f"{arch}__{shape}__pod.json"), "w") as f:
            json.dump(rec, f)
    with open(os.path.join(dirpath, "bad__train_4k__pod.json"), "w") as f:
        json.dump({"ok": False}, f)


def test_workloads_from_artifacts_match_reference(tmp_path):
    _write_artifacts(str(tmp_path))
    got = characterize.workloads_from_artifacts(str(tmp_path), n_steps=3, objective="edp")
    want = ref_characterize.workloads_from_artifacts(str(tmp_path), n_steps=3,
                                                     objective="edp")
    assert len(got) == len(want) == 4

    def view(w):
        return (w.arch, dataclasses.asdict(w.cell), w.n_steps, w.objective,
                dataclasses.asdict(w.terms), w.shape_name)

    assert sorted(map(view, got)) == sorted(map(view, want))
    assert {w.shape_name for w in got} == {"train_4k", "prefill_32k", "renamed_1k"}


def _inject_power(module, power):
    """``module.fleet_engine`` with ``power_model`` injected; returns the
    restore function."""
    inner = module.fleet_engine

    def fleet_engine(pool, **kw):
        return inner(pool, **dict(kw, power_model=power))

    module.fleet_engine = fleet_engine
    return lambda: setattr(module, "fleet_engine", inner)


def test_artifacts_cli_matches_reference(tmp_path):
    _write_artifacts(str(tmp_path))
    argv = ["--quick", "--artifacts", str(tmp_path)]
    kw = ref_main._grids(True, 0)[0]
    rp = ref_scheduler.fleet_engine(ref_cluster.make_pool(4, seed=0), **kw).power
    runs = {}
    for key, module, power, extra in (
            ("ref", ref_main, rp, []),
            ("port", port_main, PowerModel(*(float(c) for c in (rp.c1, rp.c2, rp.c3, rp.c4))),
             ["--device", CPU])):
        restore = _inject_power(module, power)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                runs[key] = module.main(argv + extra)
        finally:
            restore()
    assert set(runs["port"].scenarios) == {"engine", "engine-fallback"}
    assert runs["port"].engine.n_jobs == 4
    got, pred = _strip_predicted(runs["port"].to_json())
    want, ref_pred = _strip_predicted(runs["ref"].to_json())
    assert got == want
    np.testing.assert_allclose(pred, ref_pred, rtol=PRED_REL, atol=0)


def _mixed_jobs(mod, cluster_mod, engine_mod):
    """Profiled CPU jobs with TPU jobs of explicit roofline terms between
    them (no dry-run artifact, no analytic roofline)."""
    from repro_torch.core.node_sim import F_MAX, PROFILES

    apps = sorted(PROFILES)
    bases = [engine_mod.RooflineTerms(compute_s=c, memory_s=m, collective_s=k, source="synthetic")
             for c, m, k in ((2.0, 0.6, 0.1), (0.4, 1.1, 0.2))]
    jobs, t = [], 0.0
    for i in range(9):
        if i % 3 == 2:
            fam = cluster_mod.TermsFamily(base=bases[i % 2], app=f"zoo{i % 2}:train_4k",
                                          time_scale=120.0)
            est = fam.step_time(1.1, 256)
            jobs.append(mod.Job(i, fam.app, fam.input_size, deadline_s=t + 3.0 * est,
                                arrival_s=t, terms=fam, device="tpu"))
        else:
            app = apps[i % len(apps)]
            jobs.append(mod.Job(i, app, 1.0, deadline_s=t + 3.0 * PROFILES[app].time(
                F_MAX, 16, 1.0), arrival_s=t))
        t += 180.0
    return jobs


def test_mixed_pool_with_explicit_terms_matches_reference():
    from repro.core import tpu_power as ref_tpu_power
    from repro.core.power import PowerModel as RefPowerModel

    cpu_kw, tpu_kw = ref_main._grids(True, 0)[:2]
    ref_pool = ref_cluster.make_mixed_pool(2, 2, seed=0)
    powers = {"cpu": ref_scheduler.fleet_engine(ref_pool, **cpu_kw).power,
              "tpu": ref_tpu_power.fit_fleet_power(ref_tpu_power.FleetTelemetry(seed=0))}
    assert isinstance(powers["tpu"], RefPowerModel)

    def port_pm(p):
        return PowerModel(*(float(c) for c in (p.c1, p.c2, p.c3, p.c4)))

    common = dict(n_cpu=2, n_tpu=2, seed=0, char_freqs=None, char_cores=None,
                  migration=None, drift_events=[(400.0, "zoo1:train_4k", 1.6)])
    ref_rep, ref_sched = ref_report.run_mixed_fleet_comparison(
        _mixed_jobs(ref_scheduler, ref_cluster, ref_engine),
        cpu_engine_kw=dict(cpu_kw, power_model=powers["cpu"]),
        tpu_engine_kw=dict(tpu_kw, power_model=powers["tpu"]), **common)
    rep, sched = report.run_mixed_fleet_comparison(
        _mixed_jobs(scheduler, cluster, engine),
        cpu_engine_kw=dict(cpu_kw, power_model=port_pm(powers["cpu"]), device=CPU),
        tpu_engine_kw=dict(tpu_kw, power_model=port_pm(powers["tpu"]), device=CPU), **common)
    assert {c.placement.job.device for c in sched.completed} == {"cpu", "tpu"}
    assert job_rows(sched) == job_rows(ref_sched)
    got, pred = _strip_predicted(rep.to_json())
    want, ref_pred = _strip_predicted(ref_rep.to_json())
    assert got == want
    np.testing.assert_allclose(pred, ref_pred, rtol=PRED_REL, atol=0)
    assert set(sched.engines) == {"cpu", "tpu"}
    assert all(e.device == torch.device(CPU) for e in sched.engines.values())


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------


def test_traced_run_is_bit_for_bit_and_summarized(tmp_path, capsys):
    path = str(tmp_path / "trace.json")
    plain = port_main.main(["--quick", "--device", CPU])
    traced = port_main.main(["--quick", "--device", CPU, "--trace", path])
    off, on = plain.to_json(), traced.to_json()
    for doc in (off, on):
        for s in doc["scenarios"].values():
            s.pop("obs_rollup")
    assert json.dumps(off, sort_keys=True, default=float) == json.dumps(
        on, sort_keys=True, default=float)
    assert traced.engine.obs_rollup["counters"]["fleet.rounds"] > 0
    capsys.readouterr()
    assert obs_main([path]) == 0
    out = capsys.readouterr().out
    assert "schema v1" in out and "fleet.round" in out and "fleet.rounds" in out
    assert obs_main([path, "--json"]) == 0
    rollup = json.loads(capsys.readouterr().out)
    assert {"fleet.round", "engine.pareto_many"} <= {r["name"] for r in rollup["spans"]}
    assert not obs.enabled()


# ---------------------------------------------------------------------------
# the planner and the entry points
# ---------------------------------------------------------------------------


def test_planner_plans_an_artifact_like_the_reference(tmp_path):
    from repro.core.tpu_power import FleetTelemetry as RefTelemetry
    from repro.core.tpu_power import fit_fleet_power as ref_fit

    _write_artifacts(str(tmp_path))
    rp = ref_fit(RefTelemetry())
    mine = planner.EnergyOptimalPlanner(
        PowerModel(*(float(c) for c in (rp.c1, rp.c2, rp.c3, rp.c4))),
        dryrun_dir=str(tmp_path), device=CPU)
    theirs = ref_planner.EnergyOptimalPlanner(rp, dryrun_dir=str(tmp_path))
    for arch, shape in (("gem", "train_4k"), ("qwn", "prefill_32k")):
        got = mine.plan_for_workload(arch, SHAPES[shape], max_step_time_s=50.0)
        want = theirs.plan_for_workload(arch, REF_SHAPES[shape], max_step_time_s=50.0)
        assert (got.chips, got.pods, got.frequency_ghz) == (want.chips, want.pods,
                                                             want.frequency_ghz)
        assert got.step_time_s == pytest.approx(want.step_time_s, rel=PRED_REL)
    assert mine.engine.device == torch.device(CPU)
    # no artifact for a zoo arch: both take the analytic roofline
    for arch in ("starcoder2-3b", "gemma3-12b"):
        got = mine.plan_for_workload(arch, SHAPES["train_4k"])
        want = theirs.plan_for_workload(arch, REF_SHAPES["train_4k"])
        assert got.terms_source == want.terms_source == "analytic"
        assert (got.chips, got.pods, got.frequency_ghz) == (want.chips, want.pods,
                                                             want.frequency_ghz)
        assert got.step_time_s == pytest.approx(want.step_time_s, rel=PRED_REL)
        assert got.energy_per_step_j == pytest.approx(want.energy_per_step_j, rel=PRED_REL)


def _service_lines(module, argv):
    """``module.main(argv)``'s printed ``service`` lines, the journal's
    path written as FILE."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith(("service", "resumed from"))]
    journal = argv[argv.index("--journal") + 1] if "--journal" in argv else (
        argv[argv.index("--resume") + 1] if "--resume" in argv else None)
    return [ln.replace(journal, "FILE") if journal else ln for ln in lines]


SERVICE_RUNS = {
    "service": [["--quick", "--service"]],
    "journal": [["--quick", "--service", "--journal", "{j}"]],
    "kill-resume": [["--quick", "--service", "--journal", "{j}", "--kill-at", "1500"],
                    ["--resume", "{j}"]],
    # the mixed CPU + TPU pool (the zoo's TPU jobs on the analytic roofline)
    "mixed": [["--quick", "--service", "--mixed"]],
}


@pytest.mark.parametrize("run", sorted(SERVICE_RUNS))
def test_service_flags_print_the_reference_service_line(run, tmp_path):
    """``--service``, ``--service --journal``, ``--kill-at`` then
    ``--resume``, ``--service --mixed``: the port prints the reference
    CLI's lines, word for word."""
    for step in SERVICE_RUNS[run]:
        mine = [a.format(j=str(tmp_path / "port.json")) for a in step]
        theirs = [a.format(j=str(tmp_path / "ref.json")) for a in step]
        got = _service_lines(port_main, mine + ["--device", CPU])
        want = _service_lines(ref_main, theirs)
        want = [ln.replace("python -m repro.fleet", "python -m repro_torch.fleet") for ln in want]
        assert got == want and got, step
    if "--journal" in SERVICE_RUNS[run][0]:
        port_doc = json.loads((tmp_path / "port.json").read_text())
        ref_doc = json.loads((tmp_path / "ref.json").read_text())
        assert port_doc["config"] == ref_doc["config"]
        assert port_doc["n_batches"] == ref_doc["n_batches"]


@pytest.fixture(scope="module")
def mixed_runs():
    """``--quick --mixed`` in both packages: (report, scheduler, printed)."""
    argv = ["--quick", "--mixed"]
    return _printed(ref_main, argv), _printed(port_main, argv + ["--device", CPU])


def test_mixed_without_an_artifact_reaches_terms_analytic(mixed_runs):
    """The zoo's TPU jobs take their terms from a dry-run artifact, else the
    analytic roofline: the port prints the reference's table row for row,
    completes the same jobs, and the golden's ``mixed`` lockstep run is
    what the live reference computes."""
    (ref_rep, ref_sched, ref_out), (rep, sched, out) = mixed_runs
    assert out == ref_out and "fleet: 4 nodes, 12 jobs" in out
    assert job_rows(sched) == job_rows(ref_sched)
    assert sum(c.placement.job.device == "tpu" for c in sched.completed) == 4
    with open(GOLDEN) as f:
        gold = json.load(f)["mixed"]["lockstep"]
    live = json.loads(json.dumps(dict(argv=["--quick", "--mixed"],
                                      **run_record(ref_rep, ref_sched))))
    assert live == gold
    mine = json.loads(json.dumps(run_record(rep, sched)))
    for key in ("jobs", "scenarios", "refits", "migrations"):
        assert mine[key] == gold[key], key
    np.testing.assert_allclose(mine["predicted_energy_j"], gold["predicted_energy_j"],
                               rtol=PRED_REL, atol=0)


def _same_document(mine, theirs, where="$"):
    """Keys, types and non-float values of two JSON documents equal; floats
    within PRED_REL (1e-9 absolute near zero). The telemetry's prediction
    errors, observed / predicted - 1, move by (1 + error) x the
    prediction's relative difference, so they are held to PRED_REL x
    (1 + |error|)."""
    assert type(mine) is type(theirs) or {type(mine), type(theirs)} <= {int, float}, where
    if isinstance(mine, dict):
        assert sorted(mine) == sorted(theirs), where
        for k in mine:
            _same_document(mine[k], theirs[k], f"{where}.{k}")
    elif isinstance(mine, list):
        assert len(mine) == len(theirs), where
        for i, (a, b) in enumerate(zip(mine, theirs)):
            _same_document(a, b, f"{where}[{i}]")
    elif isinstance(mine, float) or isinstance(theirs, float):
        scale = 1.0 + abs(theirs) if ".telemetry.errors" in where else abs(theirs)
        assert abs(mine - theirs) <= max(1e-9, PRED_REL * scale), (where, mine, theirs)
    else:
        assert mine == theirs, where


def test_mixed_service_kill_and_resume_match_the_reference(tmp_path):
    """``--quick --service --mixed`` killed before its middle batch (the
    golden's kill point) in both packages: the journals hold the same keys
    and non-float values, floats within PRED_REL; the port's resume prints
    the reference's uninterrupted service line; and the golden's ``mixed``
    service run is what the live reference computes."""
    from helpers.make_torch_port_fleet_golden import mixed_service_record

    with open(GOLDEN) as f:
        gold = json.load(f)["mixed"]
    assert json.loads(json.dumps(mixed_service_record(ref_main))) == gold["service"]
    kill = gold["service"]["kill"]
    argv = ["--quick", "--service", "--mixed", "--journal", "{j}", "--kill-at",
            repr(kill["at_s"])]
    for pkg, extra in ((port_main, ["--device", CPU]), (ref_main, [])):
        pkg.main([a.format(j=str(tmp_path / f"{pkg.__name__}.json")) for a in argv] + extra)
    mine = json.loads((tmp_path / f"{port_main.__name__}.json").read_text())
    theirs = json.loads((tmp_path / f"{ref_main.__name__}.json").read_text())
    assert (mine["n_batches"], mine["now_s"]) == (kill["committed"], kill["now_s"])
    _same_document(mine, theirs)
    resumed = _service_lines(port_main, ["--resume", str(tmp_path / f"{port_main.__name__}.json"),
                                         "--device", CPU])
    uninterrupted = _service_lines(ref_main, ["--quick", "--service", "--mixed"])
    # the resumed run prints the uninterrupted one's jobs, energy, makespan,
    # misses and batch count
    assert [ln for ln in resumed if ln.startswith("service (resumed):")] == [
        ln.replace("service:", "service (resumed):").replace("reaction rounds", "batches total")
        for ln in uninterrupted]


def test_service_mode_and_default_device_raise():
    pool = cluster.make_pool(4, seed=0)
    stats, _ = report.run_engine_fleet(
        pool, [], engine=scheduler.fleet_engine(pool, device=CPU), service=True)
    assert stats.n_jobs == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            report.run_engine_fleet(pool, [], service=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(["--quick", "--service"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scheduler.fleet_engine(pool)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(["--quick"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            planner.EnergyOptimalPlanner.default()
    # a mixed pool's engines share one torch device
    mixed = cluster.make_mixed_pool(2, 2, seed=0)
    cpu_engine = scheduler.fleet_engine(mixed, device=CPU)
    with pytest.raises(ValueError, match="one torch device"):
        scheduler.FleetScheduler(mixed, {"cpu": cpu_engine, "tpu": _OtherDevice(cpu_engine)})


class _OtherDevice:
    """An engine stand-in on another torch device."""

    def __init__(self, eng):
        self.power, self.freq_grid, self.chip_grid = eng.power, eng.freq_grid, eng.chip_grid
        self.device = torch.device("meta")
