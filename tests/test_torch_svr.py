"""Port parity, ε-SVR: ``repro_torch.core.svr`` (device="cpu") against the
live ``repro.core.svr`` on ``tests/test_svr_batch.py``'s cases, and the
predict paths on reference fits carried across by ``convert``.

Tolerances, and why: the two Gram builds differ in the last bits (XLA's
dot against the port's left-to-right sum). The KKT systems are
near-singular RBF Grams conditioned only by the ridge, so those bits move
the dual coefficients by up to ~3e-4 of their largest magnitude (observed
on these cases) while the fitted surfaces move by ~5e-5 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svr as jsvr
from repro.core.engine import solve_grid
from repro_torch import convert
from repro_torch.core import svr as tsvr

ENGINE_KW = dict(gamma=0.5, standardize=True, log_target=True, eps=1e-4)
BETA_REL = 1e-3  # of max |beta|
BIAS_ABS = 5e-4
PRED_REL = 2e-4
PAE_ABS = 1e-4


def _toy_set(rng, n, scale=1.0):
    x = np.stack(
        [rng.uniform(0.6, 1.1, n),
         rng.choice([16.0, 32.0, 64.0, 128.0, 256.0, 512.0], n)], 1
    ).astype(np.float32)
    t = scale * (0.01 / x[:, 0]) * (256.0 / x[:, 1]) + 0.002 * scale
    y = np.maximum(t * (1 + rng.normal(0, 0.02, n)), 1e-6).astype(np.float32)
    return x, y


def _fields(model):
    return {k: (np.asarray(v) if not isinstance(v, (float, bool)) else v)
            for k, v in dataclasses.asdict(model).items()}


CASES = {
    "same_shape": (0, (48, 48, 48, 48)),
    "ragged": (1, (24, 48, 36)),
    "chosen_configs": (3, (66, 66, 66)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_many_matches_reference(case):
    seed, ns = CASES[case]
    rng = np.random.default_rng(seed)
    sets = [_toy_set(rng, n, scale=i + 1) for i, n in enumerate(ns)]
    ref = jsvr.fit_many(sets, **ENGINE_KW)
    port = tsvr.fit_many(sets, device="cpu", **ENGINE_KW)
    for (x, y), a, b in zip(sets, ref, port):
        beta_a = np.asarray(a.beta)
        assert b.beta.dtype == torch.float32 and b.beta.shape == beta_a.shape
        np.testing.assert_allclose(
            b.beta.numpy(), beta_a, rtol=0, atol=BETA_REL * np.abs(beta_a).max())
        assert b.bias == pytest.approx(a.bias, abs=BIAS_ABS)
        assert (b.y_mean, b.y_std) == (a.y_mean, a.y_std)
        np.testing.assert_array_equal(b.x_train.numpy(), np.asarray(a.x_train))
        np.testing.assert_allclose(
            tsvr.predict(b, x).numpy(), np.asarray(jsvr.predict(a, x)), rtol=PRED_REL)
        assert tsvr.pae(b, x, y) == pytest.approx(jsvr.pae(a, x, y), abs=PAE_ABS)


def test_fit_many_chosen_configs_match_reference():
    """The contract that matters downstream: identical (f, p) argmin picks."""
    rng = np.random.default_rng(3)
    sets = [_toy_set(rng, 66, scale=i + 1) for i in range(3)]
    ref = jsvr.fit_many(sets, **ENGINE_KW)
    port = tsvr.fit_many(sets, device="cpu", **ENGINE_KW)
    F, P = np.meshgrid(
        np.round(np.arange(0.6, 1.101, 0.05), 3), (16, 32, 64, 128, 256, 512),
        indexing="ij")
    grid = np.stack([F.ravel(), P.ravel()], 1).astype(np.float32)
    W = 100.0 + P * F**3
    for a, b in zip(ref, port):
        Ta = np.asarray(jsvr.predict(a, grid)).reshape(F.shape)
        Tb = tsvr.predict(b, grid).numpy().reshape(F.shape)
        assert solve_grid(F, P, Tb, W) == solve_grid(F, P, Ta, W)


def test_fit_is_the_b1_view_of_fit_many():
    rng = np.random.default_rng(5)
    x, y = _toy_set(rng, 30)
    one = tsvr.fit(x, y, device="cpu", **ENGINE_KW)
    many = tsvr.fit_many([(x, y)], device="cpu", **ENGINE_KW)[0]
    assert torch.equal(one.beta, many.beta) and one.bias == many.bias


def test_paper_mode_fit_on_raw_features(blackscholes_ch):
    """Raw (f, p, N) features and targets, the paper's γ and C: the evaluate
    path's fit."""
    from repro.core.characterize import subsample

    ch = subsample(blackscholes_ch, 0.2, seed=0)
    a = jsvr.fit(ch.features, ch.times)
    b = tsvr.fit(ch.features, ch.times, device="cpu")
    pa = np.asarray(jsvr.predict(a, ch.features))
    np.testing.assert_allclose(tsvr.predict(b, ch.features).numpy(), pa, rtol=PRED_REL)
    assert tsvr.pae(b, ch.features, ch.times) < 0.10


@pytest.fixture(scope="module")
def reference_models():
    rng = np.random.default_rng(4)
    sets = [_toy_set(rng, 32, scale=i + 1) for i in range(3)]
    return sets, jsvr.fit_many(sets, **ENGINE_KW)


def test_predict_each_on_carried_reference_fits(reference_models):
    """Same dual coefficients on both sides: only the Gram and the float32
    matvec differ. The matvec sums dual terms of magnitude ~100 to a result
    of order 1, so its rounding reaches PRED_REL (observed 4e-5)."""
    sets, ref = reference_models
    port = [convert.svr_params_from_reference(_fields(m), device="cpu") for m in ref]
    queries = [s[0] for s in sets]
    want = jsvr.predict_each(ref, queries)
    got = tsvr.predict_each(port, queries)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PRED_REL)


def test_predict_many_on_carried_reference_fits(reference_models):
    sets, ref = reference_models
    port = [convert.svr_params_from_reference(_fields(m), device="cpu") for m in ref]
    grid = _toy_set(np.random.default_rng(9), 40)[0]
    want = jsvr.predict_many(ref, grid)
    got = tsvr.predict_many(port, grid)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PRED_REL)


def test_predict_each_heterogeneous_falls_back_per_model():
    rng = np.random.default_rng(5)
    a = tsvr.fit(*_toy_set(rng, 20), device="cpu", **ENGINE_KW)
    b = tsvr.fit(*_toy_set(rng, 28), device="cpu", **ENGINE_KW)
    queries = [_toy_set(rng, 7)[0], _toy_set(rng, 9)[0]]
    out = tsvr.predict_each([a, b], queries)
    assert torch.equal(out[0], tsvr.predict(a, queries[0]))
    assert torch.equal(out[1], tsvr.predict(b, queries[1]))


def test_rff_route_matches_reference():
    """method="rff" is numpy end to end in both packages: identical."""
    rng = np.random.default_rng(6)
    sets = [_toy_set(rng, 80, scale=i + 1) for i in range(2)]
    ref = jsvr.fit_many(sets, method="rff", **ENGINE_KW)
    port = tsvr.fit_many(sets, method="rff", device="cpu", **ENGINE_KW)
    for (x, _), a, b in zip(sets, ref, port):
        np.testing.assert_array_equal(b.beta, a.beta)
        np.testing.assert_array_equal(tsvr.predict(b, x), jsvr.predict(a, x))


def test_auto_route_splits_a_mixed_batch():
    rng = np.random.default_rng(8)
    sets = [_toy_set(rng, 20), _toy_set(rng, 40)]
    models = tsvr.fit_many(sets, method="auto", rff_threshold=30, device="cpu",
                           **ENGINE_KW)
    assert isinstance(models[0], tsvr.SVRParams)
    assert not isinstance(models[1], tsvr.SVRParams)
    preds = tsvr.predict_each(models, [s[0] for s in sets])
    for (x, y), p in zip(sets, preds):
        assert tsvr.pae_from_pred(p, y) < 0.2


def test_unported_options_raise_and_empty_batches_are_empty():
    assert tsvr.fit_many([], device="cpu") == []
    # the ISTA polish is ported: iters > 0 fits (tests/test_torch_svr_cv.py)
    (polished,) = tsvr.fit_many([_toy_set(np.random.default_rng(0), 8)], iters=5,
                                device="cpu")
    assert np.isfinite(polished.beta.numpy()).all() and np.isfinite(polished.bias)
    with pytest.raises(ValueError, match="unknown fit method"):
        tsvr.fit_many([_toy_set(np.random.default_rng(0), 8)], method="x", device="cpu")


def test_convert_power_model_roundtrip():
    from repro.core.power import PowerModel

    ref = PowerModel(0.29, 0.97, 198.59, 9.18)
    port = convert.power_model_from_reference(ref.coeffs())
    assert port.coeffs() == ref.coeffs()
    assert float(port(2.0, 16, 1)) == float(ref(2.0, 16, 1))
    assert float(np.asarray(ref(jnp.asarray(2.0), 16, 1))) == float(port(2.0, 16, 1))
