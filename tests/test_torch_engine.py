"""Port parity, planning engine: ``repro_torch.core.engine`` (device="cpu")
against the live ``repro.core.engine`` on ``cpu_space()`` engines with
``AppTerms`` workloads (4 apps x 5 inputs, B = 200) under mixed objectives
and constraints, including rows no grid point satisfies.

Chosen (f, cores) and frontier membership must be identical. Energies:
with each package fitting its own SVRs, the fits differ as
``test_torch_svr`` describes (observed 1.6e-4 relative on plan energies;
ENERGY_REL_OWN_FIT); with the reference fits carried across, only the
float32 grid prediction differs (ENERGY_REL_CARRIED). Within the port, the
fused and exact paths agree bit for bit.

Frontier membership is compared on carried fits only. On these workloads
the two packages' own fits differ by up to 4.5e-4 relative on the grid,
while the closest frontier decision (a point's energy against the running
minimum of the faster points) is 6.6e-5 relative: membership on own fits
would hold by luck of where the fit differences land, not by the port.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs.base import SHAPES as J_SHAPES
from repro.core import engine as jeng
from repro.core import power as jpow
from repro.core.node_sim import Node
from repro.fleet.cluster import family_key as j_family_key
from repro_torch import convert
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.core import engine as teng
from repro_torch.fleet.cluster import AppTerms, family_key as t_family_key

APPS = ("blackscholes", "fluidanimate", "raytrace", "swaptions")
ENERGY_REL_OWN_FIT = 1e-3
ENERGY_REL_CARRIED = 2e-4


def _workloads(mod, family_key, b=200, seed=1):
    rng = np.random.default_rng(seed)
    C = mod.Constraints
    ws = []
    for i in range(b):
        app, n = APPS[i % 4], float(1 + (i // 4) % 5)
        kind = int(rng.integers(5))
        c = [None,
             C(max_cores=int(rng.integers(1, 33))),
             C(max_time_s=float(rng.uniform(10.0, 2000.0))),
             C(max_time_s=float(rng.uniform(50.0, 3000.0)), max_cores=16,
               min_frequency_ghz=1.4, max_frequency_ghz=2.0),
             C(max_time_s=1e-3, max_cores=16)][kind]  # the last: infeasible
        ws.append(mod.Workload(
            arch=app, terms=family_key(app, n), n_steps=int(rng.integers(1, 4)),
            objective=("energy", "edp", "ed2p")[int(rng.integers(3))],
            constraints=c))
    return ws


@pytest.fixture(scope="module")
def power_coeffs():
    return jpow.fit_power_model(*Node(seed=7).stress_grid()).coeffs()


@pytest.fixture(scope="module")
def engines(power_coeffs):
    ref = jeng.PlanningEngine(
        jpow.PowerModel(*power_coeffs), space=jeng.cpu_space(), noise=0.01, seed=0)
    port = teng.PlanningEngine(
        convert.power_model_from_reference(power_coeffs), space=teng.cpu_space(),
        noise=0.01, seed=0, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def workloads():
    return _workloads(jeng, j_family_key), _workloads(teng, t_family_key)


def _same_configs(a, b):
    return [(p.frequency_ghz, p.chips, p.pods) for p in a] == [
        (p.frequency_ghz, p.chips, p.pods) for p in b]


def test_power_grid_and_baseline_are_bitwise(engines):
    ref, port = engines
    np.testing.assert_array_equal(port._W, np.asarray(ref._W))
    assert port._w_base == ref._w_base
    np.testing.assert_array_equal(port._grid_feats, ref._grid_feats)


def test_plan_many_matches_reference(engines, workloads):
    ref, port = engines
    want, got = ref.plan_many(workloads[0]), port.plan_many(workloads[1])
    assert len(got) == len(want) == 200 and _same_configs(got, want)
    for a, b in zip(got, want):
        assert (a.arch, a.objective, a.n_steps, a.mesh) == (b.arch, b.objective, b.n_steps, b.mesh)
        assert a.energy_per_step_j == pytest.approx(b.energy_per_step_j, rel=ENERGY_REL_OWN_FIT)
        assert a.power_w == b.power_w
        assert a.baseline_energy_j == pytest.approx(b.baseline_energy_j, rel=1e-12)


def _carry_fits(ref, port, keys_ref, keys_port):
    for kr, kp in zip(keys_ref, keys_port):
        fit = ref._fits[kr]
        fields = {k: (np.asarray(v) if not isinstance(v, (float, bool)) else v)
                  for k, v in dataclasses.asdict(fit.model).items()}
        port.install_fit(kp, convert.svr_params_from_reference(fields, device="cpu"),
                         fit.pae, kp)


def test_pareto_many_matches_reference(engines, workloads, power_coeffs):
    """The 200 frontiers of the module's workloads, the port planning over
    the reference engine's own fits (see the module note)."""
    ref, _ = engines
    want = ref.pareto_many(workloads[0])
    port = teng.PlanningEngine(
        convert.power_model_from_reference(power_coeffs), space=teng.cpu_space(),
        noise=0.01, seed=0, device="cpu")
    _carry_fits(ref, port, [w.key for w in workloads[0][:20]],
                [w.key for w in workloads[1][:20]])
    got = port.pareto_many(workloads[1])
    assert len(port._fits) == 20  # every family came from the reference
    assert len(got) == len(want) == 200
    for fa, fb in zip(got, want):
        assert [(p.frequency_ghz, p.chips) for p in fa] == [
            (p.frequency_ghz, p.chips) for p in fb]
        # a frontier reaches the grid's fast extreme, where the float32
        # prediction's sum over the support vectors cancels most: observed
        # 2.1e-4 relative there on carried fits, so the own-fit bound
        for a, b in zip(fa, fb):
            assert a.energy_per_step_j == pytest.approx(
                b.energy_per_step_j, rel=ENERGY_REL_OWN_FIT)


def test_sweep_on_carried_reference_fits(power_coeffs):
    """The grid prediction and the fused sweep alone: the port plans over
    the reference's own SVR fits, installed through ``install_fit``."""
    ref = jeng.PlanningEngine(
        jpow.PowerModel(*power_coeffs), space=jeng.cpu_space(), noise=0.01, seed=0)
    port = teng.PlanningEngine(
        convert.power_model_from_reference(power_coeffs), space=teng.cpu_space(),
        noise=0.01, seed=0, device="cpu")
    wr, wp = _workloads(jeng, j_family_key, seed=5), _workloads(teng, t_family_key, seed=5)
    want = ref.plan_many(wr)
    _carry_fits(ref, port, [w.key for w in wr[:20]], [w.key for w in wp[:20]])
    got = port.plan_many(wp)
    assert _same_configs(got, want)
    for a, b in zip(got, want):
        assert a.svr_pae == b.svr_pae
        assert a.energy_per_step_j == pytest.approx(b.energy_per_step_j, rel=ENERGY_REL_CARRIED)
    fr_want, fr_got = ref.pareto_many(wr), port.pareto_many(wp)
    assert [[(p.frequency_ghz, p.chips) for p in f] for f in fr_got] == [
        [(p.frequency_ghz, p.chips) for p in f] for f in fr_want]


def test_plan_many_fused_matches_exact_bitwise(engines, workloads):
    _, port = engines
    fused = port.plan_many(workloads[1])
    exact = port.plan_many(workloads[1], fused=False)
    plain = port.plan_many(workloads[1], impl="ref")
    for a, b, c in zip(fused, exact, plain):
        for f in dataclasses.fields(teng.EnergyPlan):
            assert getattr(a, f.name) == getattr(b, f.name) == getattr(c, f.name), f.name


def test_pareto_many_fused_matches_exact_bitwise(engines, workloads):
    _, port = engines
    fused = port.pareto_many(workloads[1])
    assert fused == port.pareto_many(workloads[1], fused=False)
    assert fused == port.pareto_many(workloads[1], impl="ref")
    assert all(fr for fr in fused)


def test_infeasible_rows_take_the_fastest_fallback(engines, workloads):
    _, port = engines
    ws = [w for w in workloads[1] if w.constraints is not None
          and w.constraints.max_time_s == 1e-3]
    assert ws
    for p in port.plan_many(ws):
        assert p.chips <= 16  # the core cap survives the fallback


def test_plan_is_the_b1_view_of_plan_many(engines, workloads):
    _, port = engines
    ws = workloads[1][:5]
    batched = port.plan_many(ws)
    for w, p in zip(ws, batched):
        assert port.plan(w) == p
    assert port.pareto(ws[0]) == port.pareto_many(ws)[0]


def test_memo_builds_one_callable_per_geometry(engines):
    _, port = engines
    used = {key[1][0] for key in teng._GRID_CALLABLE_CACHE}
    b = next(n for n in range(3, 400) if n not in used)
    ws = [teng.Workload(arch="swaptions", terms=AppTerms("swaptions", 2.0),
                        n_steps=i + 1) for i in range(b)]
    before = dict(teng.TRACE_COUNTS)
    port.plan_many(ws)
    port.pareto_many(ws)
    assert teng.TRACE_COUNTS["plan_argmin"] == before["plan_argmin"] + 1
    assert teng.TRACE_COUNTS["pareto"] == before["pareto"] + 1
    mid = dict(teng.TRACE_COUNTS)
    port.plan_many(list(ws))
    port.pareto_many(ws)
    assert teng.TRACE_COUNTS == mid
    port.plan_many(ws, impl="ref")  # a new impl is a new geometry key
    assert teng.TRACE_COUNTS["plan_argmin"] == mid["plan_argmin"] + 1


def test_tpu_space_with_roofline_terms_matches_reference(fleet_pm):
    terms = [jeng.RooflineTerms(0.02, 0.008, 0.004, "synthetic"),
             jeng.RooflineTerms(0.001, 0.05, 0.002, "synthetic")]
    tterms = [teng.RooflineTerms(t.compute_s, t.memory_s, t.collective_s, t.source)
              for t in terms]
    ref = jeng.PlanningEngine(fleet_pm, noise=0.01, seed=0)
    port = teng.PlanningEngine(convert.power_model_from_reference(fleet_pm.coeffs()),
                               noise=0.01, seed=0, device="cpu")
    want = ref.plan_many([jeng.Workload("a", terms=t, objective="edp") for t in terms])
    got = port.plan_many([teng.Workload("a", terms=t, objective="edp") for t in tterms])
    assert _same_configs(got, want)


def test_solve_grid_semantics_are_the_references():
    rng = np.random.default_rng(2)
    F, C, _ = teng.cpu_space().meshes()
    T = rng.uniform(1.0, 100.0, F.shape)
    W = rng.uniform(100.0, 400.0, F.shape)
    for obj in ("energy", "edp", "ed2p"):
        for c in (None, teng.Constraints(max_cores=8),
                  teng.Constraints(max_time_s=0.5, max_cores=8)):
            jc = None if c is None else jeng.Constraints(**dataclasses.asdict(c))
            assert teng.solve_grid(F, C, T, W, objective=obj, constraints=c,
                                   on_infeasible="fastest") == jeng.solve_grid(
                F, C, T, W, objective=obj, constraints=jc, on_infeasible="fastest")
    with pytest.raises(ValueError, match="no configuration"):
        teng.solve_grid(F, C, T, W, constraints=teng.Constraints(max_time_s=0.5))


def test_terms_analytic_waits_for_the_model_zoo():
    """The zoo is whole: zamba2-7b (its shared block counted once),
    phi-3-vision-4.2b (with ``vision_proj``) and whisper-medium (counted
    from ``encdec.init`` on the meta device) give the reference's terms at
    every shape, as qwen1.5-110b does (``tests/test_torch_zoo.py`` holds
    every arch to the reference)."""
    for arch_id in ("zamba2-7b", "phi-3-vision-4.2b", "whisper-medium", "qwen1.5-110b"):
        for name in T_SHAPES:
            got = teng.terms_analytic(arch_id, T_SHAPES[name])
            assert dataclasses.astuple(got) == dataclasses.astuple(
                jeng.terms_analytic(arch_id, J_SHAPES[name])), (arch_id, name)


def test_terms_from_dryrun_reads_json(tmp_path):
    (tmp_path / "a__s__pod.json").write_text(
        '{"ok": true, "hlo": {"flops_per_device": 1e12}}')
    got = teng.terms_from_dryrun("a", "s", str(tmp_path))
    want = jeng.terms_from_dryrun("a", "s", str(tmp_path))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert teng.terms_from_dryrun("b", "s", str(tmp_path)) is None
