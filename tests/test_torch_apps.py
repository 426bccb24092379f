"""The port's PARSEC apps against the live JAX package, on the host.

Each app runs on the same ``make_inputs`` (numpy-seeded in both packages)
at its ``DEFAULT_N`` and at a small n, and its outputs agree with the
reference's within ``SCALE_REL`` of the output's largest magnitude:

* blackscholes 1e-5 (measured 3.1e-7): float32 ``exp``/``log`` of two
  libraries, one ulp apart now and then;
* fluidanimate 1e-5 (measured 2.4e-7): all-pairs sums of up to n float32
  terms in another order; the cutoff mask is continuous (every pair term
  is 0 at r = h), so a pair that falls on the other side of it moves
  nothing;
* raytrace 5e-4 (measured 9.0e-5): the specular term raises a float32
  cosine to the 32nd power, so a last-bit difference grows 32-fold, and
  the mirror bounce starts from the first hit's rounded point. The pixel
  grid is the reference's bit for bit. A pixel whose nearest hit, shadow
  or silhouette is decided within an ulp could land on the other side in
  one package; no pixel of these images does, so every pixel is held to
  the tolerance, and such a pixel would fail the test;
* swaptions 1e-5 (measured 2.0e-7) when fed the reference's
  ``jax.random`` shocks as ``z``; on its own ``torch.Generator`` draws
  each price lies within 4 sqrt(se_port^2 + se_ref^2) of the reference's.

Then the reference's domain properties (``tests/test_apps.py``) on the
port: finite, deterministic, put-call parity, price bounds, image range,
converging prices, box and mass. The committed golden that
``chip_smoke.py`` holds the card's apps to must equal the live reference.
"""

import jax
import numpy as np
import pytest
import torch

from helpers import make_torch_port_service_golden as golden
from repro.apps import APPS as REF_APPS
from repro_torch.apps import APPS, blackscholes, fluidanimate, raytrace, swaptions

CPU = "cpu"
SCALE_REL = {"blackscholes": 1e-5, "fluidanimate": 1e-5, "raytrace": 5e-4, "swaptions": 1e-5}
SMALL_N = {"blackscholes": 64, "fluidanimate": 64, "raytrace": 48, "swaptions": 4}
SE_WIDTH = 4.0


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


def _run_port(name, n, seed=0, ref_inputs=None):
    """The port's outputs; swaptions fed the reference's draws."""
    mod = APPS[name]
    inputs = mod.make_inputs(n, seed=seed, device=CPU)
    if name != "swaptions":
        return _np(mod.run(inputs, device=CPU))
    z = jax.random.normal(ref_inputs["key"], (swaptions.STEPS, n, swaptions.TRIALS,
                                              swaptions.FACTORS))
    price, stderr = swaptions.simulate(inputs["fwd0"], inputs["vols"], inputs["strikes"], n,
                                       z=torch.from_numpy(np.array(z)))
    return {"price": price.numpy(), "stderr": stderr.numpy()}


@pytest.mark.parametrize("size", ["default", "small"])
@pytest.mark.parametrize("name", sorted(APPS))
def test_app_matches_the_reference(name, size):
    ref = REF_APPS[name]
    n = ref.DEFAULT_N if size == "default" else SMALL_N[name]
    assert APPS[name].DEFAULT_N == ref.DEFAULT_N
    ref_inputs = ref.make_inputs(n, seed=0)
    mine_inputs = APPS[name].make_inputs(n, seed=0, device=CPU)
    for key, val in mine_inputs.items():  # the same numpy draws
        if isinstance(val, torch.Tensor):
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref_inputs[key]))
    want = {k: np.asarray(v) for k, v in ref.run(ref_inputs).items()}
    got = _run_port(name, n, ref_inputs=ref_inputs)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
        scale = float(np.abs(want[key]).max())
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= SCALE_REL[name] * scale, (name, n, key, err / scale)


def test_swaptions_own_draws_agree_statistically():
    n = swaptions.DEFAULT_N
    want = {k: np.asarray(v) for k, v in
            REF_APPS["swaptions"].run(REF_APPS["swaptions"].make_inputs(n, seed=0)).items()}
    got = _np(swaptions.run(swaptions.make_inputs(n, seed=0, device=CPU), device=CPU))
    width = SE_WIDTH * np.sqrt(got["stderr"] ** 2 + want["stderr"] ** 2)
    assert (np.abs(got["price"] - want["price"]) <= width).all()
    # the draws are the generator's: another seed, other prices
    other = _np(swaptions.run(swaptions.make_inputs(n, seed=1, device=CPU), device=CPU))
    assert not np.array_equal(other["price"], got["price"])


def test_committed_apps_golden_equals_the_live_reference():
    with np.load(golden.APPS_GOLDEN) as f:
        committed = {k: f[k] for k in f.files}
    live = golden.apps_outputs()
    assert sorted(committed) == sorted(live)
    for key in live:
        np.testing.assert_array_equal(committed[key], live[key])


# ---------------------------------------------------------------------------
# the reference's domain properties, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(APPS))
def test_apps_run_finite(name):
    mod = APPS[name]
    out = mod.run(mod.make_inputs(mod.DEFAULT_N, seed=0, device=CPU), device=CPU)
    for k, v in out.items():
        assert bool(torch.isfinite(v).all()), (name, k)


@pytest.mark.parametrize("name", sorted(APPS))
def test_apps_deterministic(name):
    mod = APPS[name]
    n = 64 if name != "swaptions" else 4
    o1 = mod.run(mod.make_inputs(n, seed=1, device=CPU), device=CPU)
    o2 = mod.run(mod.make_inputs(n, seed=1, device=CPU), device=CPU)
    for k in o1:
        assert torch.equal(o1[k], o2[k])


def test_blackscholes_put_call_parity():
    """C - P = S - K e^{-rT} — analytic identity, holds for any inputs."""
    rng = np.random.default_rng(7)
    m = 200
    cols = {
        "spot": rng.uniform(30.0, 100.0, m), "strike": rng.uniform(30.0, 100.0, m),
        "rate": rng.uniform(0.01, 0.05, m), "vol": rng.uniform(0.15, 0.5, m),
        "tte": rng.uniform(0.2, 1.5, m),
    }
    inp = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
    call = blackscholes.run({**inp, "is_call": torch.ones(m, dtype=torch.bool)}, device=CPU)
    put = blackscholes.run({**inp, "is_call": torch.zeros(m, dtype=torch.bool)}, device=CPU)
    s, k, r, t = (inp[c].double().numpy() for c in ("spot", "strike", "rate", "tte"))
    parity = s - k * np.exp(-r * t)
    gap = np.abs((call["price"].double() - put["price"].double()).numpy() - parity)
    assert (gap < 2e-2).all()  # polynomial CNDF tolerance


def test_blackscholes_price_bounds():
    inp = blackscholes.make_inputs(512, seed=2, device=CPU)
    price = blackscholes.run(inp, device=CPU)["price"].numpy()
    spot, strike = inp["spot"].numpy(), inp["strike"].numpy()
    assert (price >= -1e-3).all()
    bound = np.where(inp["is_call"].numpy(), spot, strike)  # C <= S,  P <= K
    assert (price <= bound + 1e-3).all()


def test_raytrace_image_range_and_content():
    img = raytrace.run(raytrace.make_inputs(48, seed=0, device=CPU), device=CPU)["image"].numpy()
    assert img.shape == (48, 48, 3)
    assert (img >= 0).all() and (img <= 1).all()
    assert img.std() > 0.01  # actually rendered something


def test_swaptions_prices_nonnegative_and_converging():
    out = swaptions.run(swaptions.make_inputs(8, seed=0, device=CPU), device=CPU)
    price, stderr = out["price"].numpy(), out["stderr"].numpy()
    assert (price >= -1e-6).all()
    assert (stderr >= 0).all()
    assert (stderr < np.maximum(price, 1e-4) * 5 + 1e-3).all()


def test_fluidanimate_stays_in_box_and_conserves_mass():
    out = fluidanimate.make_inputs(216, seed=0, device=CPU)
    for _ in range(3):
        out = {**out, **fluidanimate.run({"pos": out["pos"], "vel": out["vel"]}, device=CPU)}
    pos = out["pos"].numpy()
    assert (pos >= 0).all() and (pos <= 1.0).all()
    assert (out["density"].numpy() > 0).all()


@pytest.mark.parametrize("name", sorted(APPS))
def test_apps_take_the_card_by_default(name):
    """``device=None`` is the CUDA device: without one, make_inputs and
    run raise instead of falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    mod = APPS[name]
    inputs = mod.make_inputs(4, seed=0, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(inputs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(inputs, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.make_inputs(4, seed=0)
