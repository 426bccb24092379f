"""Port parity, substrate: power model, node simulator, governors, TPU-fleet
telemetry (``repro_torch.core`` against the live ``repro.core``).

The simulator and the power model's forward pass must agree BIT FOR BIT:
the node draws its ground truth from the float32 ``PowerModel`` and its
noise from one numpy RNG stream, so any drift in operation order or draw
order would change every downstream measurement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import governor as jgov
from repro.core import node_sim as jsim
from repro.core import power as jpow
from repro.core import tpu_power as jtpu
from repro_torch.core import governor as tgov
from repro_torch.core import node_sim as tsim
from repro_torch.core import power as tpow_mod
from repro_torch.core import tpu_power as ttpu

COEFFS = (0.2904367446899414, 0.9716712832450867, 198.60833740234375, 9.093886375427246)
GOVERNORS = ("performance", "powersave", "ondemand", "conservative")


def _grid():
    F, C = np.meshgrid(jsim.FREQ_GRID, np.arange(1, 33), indexing="ij")
    return F, C, np.ceil(C / 16)


@pytest.mark.parametrize("path", ["tensor", "numpy"])
def test_power_model_on_the_352_point_grid_is_bitwise(path):
    F, C, S = _grid()
    want = np.asarray(
        jpow.PowerModel(*COEFFS)(jnp.asarray(F), jnp.asarray(C), jnp.asarray(S))
    )
    model = tpow_mod.PowerModel(*COEFFS)
    if path == "tensor":
        got = model(torch.from_numpy(F), torch.from_numpy(C), torch.from_numpy(S))
        assert got.dtype == torch.float32
        got = got.numpy()
    else:
        want = np.asarray(jpow.PowerModel(*COEFFS)(F, C, S))
        got = model(F, C, S)
    assert got.shape == (11, 32)
    np.testing.assert_array_equal(got, want)


def test_power_model_scalar_calls_are_bitwise():
    """The per-tick host path: Python scalars in, float32 out, exactly as the
    reference's jnp scalar arithmetic rounds."""
    ref, port = jpow.PowerModel(*COEFFS), tpow_mod.PowerModel(*COEFFS)
    table = np.round(np.arange(jsim.F_MIN, jsim.F_MAX + 1e-9, 0.1), 2)
    for f in table:
        for p in range(1, 33):
            s = int(np.ceil(p / 16))
            assert float(port(float(f), p, s)) == float(ref(float(f), p, s))


def test_race_to_idle_and_parcels_agree():
    ref, port = jpow.PowerModel(*COEFFS), tpow_mod.PowerModel(*COEFFS)
    assert port.race_to_idle_expected(2.2, 32, 2) == ref.race_to_idle_expected(2.2, 32, 2)
    assert port.static_parcel() == ref.static_parcel()
    assert float(port.dynamic_parcel(2.2, 32, 2)) == pytest.approx(
        float(ref.dynamic_parcel(2.2, 32, 2)), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_stress_grid_is_bitwise(seed):
    want = jsim.Node(seed=seed).stress_grid()
    got = tsim.Node(seed=seed).stress_grid()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app", sorted(jsim.PROFILES))
def test_run_fixed_is_bitwise(app):
    jn, tn = jsim.Node(seed=3), tsim.Node(seed=3)
    for f, p, n in ((1.2, 1, 1.0), (2.2, 32, 5.0), (1.7, 13, 3.0)):
        a, b = jn.run_fixed(app, f, p, n), tn.run_fixed(app, f, p, n)
        assert (a.time_s, a.energy_j, a.mean_power_w) == (b.time_s, b.energy_j, b.mean_power_w)
        np.testing.assert_array_equal(a.power_trace, b.power_trace)


@pytest.mark.parametrize("name", GOVERNORS)
def test_run_governor_is_bitwise(name):
    from repro.core import evaluate as jev
    from repro_torch.core import evaluate as tev

    table = np.asarray(jsim.FREQ_GRID, float)
    jn, tn = jsim.Node(seed=5), tsim.Node(seed=5)
    for app, p in (("blackscholes", 32), ("swaptions", 8)):
        a = jn.run_governor(app, jev.make_governor(name, table), p, 1.0)
        b = tn.run_governor(app, tev.make_governor(name, table), p, 1.0)
        assert (a.time_s, a.energy_j, a.mean_freq_ghz) == (b.time_s, b.energy_j, b.mean_freq_ghz)
        np.testing.assert_array_equal(a.freq_trace, b.freq_trace)
        np.testing.assert_array_equal(a.power_trace, b.power_trace)


@pytest.mark.parametrize(
    "cls", ["OndemandGovernor", "ConservativeGovernor", "PerformanceGovernor",
            "PowersaveGovernor"])
def test_governor_decisions_match(cls):
    rng = np.random.default_rng(11)
    a, b = getattr(jgov, cls)(), getattr(tgov, cls)()
    assert a.initial_frequency() == b.initial_frequency()
    for u in rng.uniform(0.0, 1.0, 200):
        assert a.next_frequency(float(u)) == b.next_frequency(float(u))


def _assert_fit_close(port, ref, single_socket=False):
    """float32 tolerance: the reference solves in float32 (JAX's SVD lstsq),
    the port in float64 with LAPACK gelsd and rounds to float32; the two
    differ by the float32 solve's error, ~1e-5 relative on these grids."""
    p, r = np.array(port.coeffs()), np.array(ref.coeffs())
    np.testing.assert_allclose(p[:2], r[:2], rtol=1e-4)
    if single_socket:
        # [1, s] are collinear: only c3 + c4 is identified; both solvers
        # return the minimum-norm split
        assert p[2] + p[3] == pytest.approx(r[2] + r[3], rel=1e-5)
        assert p[2] == pytest.approx(p[3], rel=1e-5)
    else:
        np.testing.assert_allclose(p[2:], r[2:], rtol=1e-4)


def test_fit_power_model_two_socket_grid():
    samples = jsim.Node(seed=7).stress_grid()
    _assert_fit_close(tpow_mod.fit_power_model(*samples), jpow.fit_power_model(*samples))


def test_fit_power_model_single_socket_grid_is_minimum_norm():
    f, p, s, w = jsim.Node(seed=7, cores_per_socket=64).stress_grid()
    assert (s == 1).all()
    port, ref = tpow_mod.fit_power_model(f, p, s, w), jpow.fit_power_model(f, p, s, w)
    assert np.isfinite(port.coeffs()).all()
    _assert_fit_close(port, ref, single_socket=True)
    F, C, _ = _grid()
    np.testing.assert_allclose(
        port(F, C, np.ones_like(F)), np.asarray(ref(F, C, np.ones_like(F))), rtol=1e-5)


def test_fit_report_agrees():
    samples = jsim.Node(seed=7).stress_grid()
    ref = jpow.fit_report(jpow.fit_power_model(*samples), *samples)
    port = tpow_mod.fit_report(tpow_mod.fit_power_model(*samples), *samples)
    assert port["ape"] == pytest.approx(ref["ape"], rel=1e-3)
    assert port["rmse_watts"] == pytest.approx(ref["rmse_watts"], rel=1e-3)


def test_fleet_telemetry_and_fleet_power_fit():
    want = jtpu.FleetTelemetry(seed=1).stress_grid()
    got = ttpu.FleetTelemetry(seed=1).stress_grid()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _assert_fit_close(
        ttpu.fit_fleet_power(ttpu.FleetTelemetry(seed=1)),
        jtpu.fit_fleet_power(jtpu.FleetTelemetry(seed=1)),
    )
