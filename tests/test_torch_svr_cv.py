"""Port parity, the paper's cross-validation (§3.4, Table 1) and the ISTA
polish: ``repro_torch.core.svr`` (device="cpu") against the live
``repro.core.svr`` on the same inputs.

Tolerances, and why: the two Gram builds differ in the last bits (XLA's
dot against the port's left-to-right sum), which moves the fitted surfaces
by ~5e-5 relative (``tests/test_torch_svr.py``). A CV metric is a mean of
per-sample errors of a few percent, so it moves by less: at most 5.4e-6
relative on these cases, held to ``CV_REL``. The ISTA polish is float32
on both sides (50 power steps, then ``iters`` steps of 50 bisections), and
its summation order differs too: dual coefficients within 7.4e-5 of their
largest magnitude, biases within 3.3e-6 and predictions within 5e-5
relative on ``tests/test_svr_batch.py``'s polish case, held to the
tolerances of ``tests/test_torch_svr.py``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro.core import characterize as jch
from repro.core import svr as jsvr
from repro_torch.core import characterize as tch
from repro_torch.core import svr as tsvr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE1_GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_table1_golden.json")
ENGINE_KW = dict(gamma=0.5, standardize=True, log_target=True, eps=1e-4)
CV_REL = 1e-4
BETA_REL = 1e-3  # of max |beta|
BIAS_ABS = 5e-4
PRED_REL = 2e-4


def _toy_set(rng, n, scale=1.0):
    x = np.stack(
        [rng.uniform(0.6, 1.1, n),
         rng.choice([16.0, 32.0, 64.0, 128.0, 256.0, 512.0], n)], 1
    ).astype(np.float32)
    t = scale * (0.01 / x[:, 0]) * (256.0 / x[:, 1]) + 0.002 * scale
    y = np.maximum(t * (1 + rng.normal(0, 0.02, n)), 1e-6).astype(np.float32)
    return x, y


def test_mae_matches_reference(blackscholes_ch):
    ch = jch.subsample(blackscholes_ch, 0.3, seed=1)
    a = jsvr.fit(ch.features, ch.times)
    b = tsvr.fit(ch.features, ch.times, device="cpu")
    want = jsvr.mae(a, blackscholes_ch.features, blackscholes_ch.times)
    got = tsvr.mae(b, blackscholes_ch.features, blackscholes_ch.times)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=CV_REL)


def test_kfold_cv_matches_reference(blackscholes_ch):
    """``tests/test_core_paper.py::test_svr_cv``'s case: the quick
    blackscholes characterization at k = 5."""
    x, y = blackscholes_ch.features, blackscholes_ch.times
    want = jsvr.kfold_cv(x, y, k=5)
    got = tsvr.kfold_cv(x, y, k=5, device="cpu")
    assert all(isinstance(v, float) for v in got)
    assert got == pytest.approx(want, rel=CV_REL)
    assert got[1] < 0.08 and got[0] < 0.1 * float(np.mean(y))


def test_kfold_cv_folds_are_the_references(monkeypatch):
    """Each fold trains on the same samples, in the same order, as the
    reference's."""
    rng = np.random.default_rng(11)
    x, y = _toy_set(rng, 23)
    seen = {"ref": [], "port": []}

    def recording(fit, key):
        def fit_and_record(xs, ys, **kw):
            seen[key].append((np.array(xs), np.array(ys)))
            return fit(xs, ys, **kw)
        return fit_and_record

    monkeypatch.setattr(jsvr, "fit", recording(jsvr.fit, "ref"))
    monkeypatch.setattr(tsvr, "fit", recording(tsvr.fit, "port"))
    jsvr.kfold_cv(x, y, k=4, seed=5, **ENGINE_KW)
    tsvr.kfold_cv(x, y, k=4, seed=5, device="cpu", **ENGINE_KW)
    assert len(seen["port"]) == len(seen["ref"]) == 4
    for (xa, ya), (xb, yb) in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(xb, xa)
        np.testing.assert_array_equal(yb, ya)


def test_grid_search_picks_the_references(blackscholes_ch):
    """A reduced grid, whose best CV PAE is well clear of the second."""
    x, y = blackscholes_ch.features, blackscholes_ch.times
    kw = dict(Cs=(1e2, 10e3), gammas=(0.1, 0.5), k=3)
    want = jsvr.grid_search(x, y, **kw)
    got = tsvr.grid_search(x, y, device="cpu", **kw)
    assert (got["C"], got["gamma"]) == (want["C"], want["gamma"])
    assert got["pae"] == pytest.approx(want["pae"], rel=CV_REL)


def test_cross_validate_matches_reference(blackscholes_ch):
    sub = jch.subsample(blackscholes_ch, 0.5, seed=2)
    port_ch = tch.Characterization(app=sub.app, features=sub.features, times=sub.times)
    want = sub.cross_validate(k=4)
    got = port_ch.cross_validate(k=4, device="cpu")
    assert got == pytest.approx(want, rel=CV_REL)
    assert port_ch.cross_validate(k=4, seed=1, device="cpu") != got  # other folds


def test_table1_golden_quick_grid_is_the_conftests(blackscholes_ch):
    """``chip_smoke.py`` builds its quick sets from the golden's
    ``quick_grid``: on the golden's grid-search node it gives the conftest's
    blackscholes set, sample for sample."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.core.node_sim import Node

    with open(TABLE1_GOLDEN) as f:
        golden = json.load(f)
    ch = smoke._quick_characterization(
        Node(seed=golden["grid_search"]["seed"]), "blackscholes", golden["quick_grid"])
    np.testing.assert_array_equal(ch.features, blackscholes_ch.features)
    np.testing.assert_array_equal(ch.times, blackscholes_ch.times)


def _dual_case(seed, b=3, n=9):
    """A random PSD Gram stack, targets, duals and a ragged mask."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 2)).astype(np.float32)
    K = np.exp(-0.5 * ((x[:, :, None] - x[:, None]) ** 2).sum(-1)).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    beta = (3.0 * rng.standard_normal((b, n))).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 6:] = False  # 6 real rows: an even count
    mask[2, 7:] = False  # 7: odd
    K *= mask[:, :, None] & mask[:, None, :]
    return K, y * mask, beta * mask, mask


def test_projection_matches_reference():
    import jax

    _, _, beta, mask = _dual_case(0)
    C = np.array([1.0, 2.5, 0.5], np.float32)
    want = jax.vmap(jsvr._project_sum_zero_box)(beta, C, mask)
    got = tsvr._project_sum_zero_box(torch.from_numpy(beta), torch.from_numpy(C),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(got.numpy().sum(1)).max() < 1e-4  # sum zero over the real rows
    assert (got.numpy()[~mask] == 0).all() and (np.abs(got.numpy()) <= C[:, None]).all()


@pytest.mark.parametrize("free", [True, False])
def test_bias_recovery_matches_reference(free):
    """With free support vectors, their mean KKT bias; without any (every
    dual at 0 or at the bound), the median of y - K beta over the real rows,
    odd and even counts alike."""
    import jax

    K, y, beta, mask = _dual_case(1)
    C = np.full(3, 2.0, np.float32)
    eps = np.full(3, 0.05, np.float32)
    if not free:
        beta = np.where(np.abs(beta) > 1.0, np.sign(beta) * 2.0, 0.0).astype(np.float32) * mask
    want = jax.vmap(jsvr._recover_bias_masked)(K, y, beta, C, eps, mask)
    got = tsvr._recover_bias_batch(*(torch.from_numpy(a) for a in (K, y, beta, C, eps, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _ista_case():
    rng = np.random.default_rng(2)
    return [_toy_set(rng, n) for n in (20, 32)]  # ragged: padded and masked


def test_fit_many_ista_polish_matches_reference():
    """``tests/test_svr_batch.py::test_fit_many_ista_polish_parity``'s two
    sets, polished by 50 ISTA steps in both packages."""
    sets = _ista_case()
    kw = dict(ENGINE_KW, iters=50)
    ref = jsvr.fit_many(sets, **kw)
    port = tsvr.fit_many(sets, device="cpu", **kw)
    unpolished = tsvr.fit_many(sets, device="cpu", **ENGINE_KW)
    xq = _toy_set(np.random.default_rng(9), 17)[0]
    for (x, _), a, b, b0 in zip(sets, ref, port, unpolished):
        beta_a = np.asarray(a.beta)
        assert b.beta.dtype == torch.float32 and b.beta.shape == beta_a.shape
        np.testing.assert_allclose(
            b.beta.numpy(), beta_a, rtol=0, atol=BETA_REL * np.abs(beta_a).max())
        assert b.bias == pytest.approx(a.bias, abs=BIAS_ABS)
        for q in (x, xq):
            np.testing.assert_allclose(
                tsvr.predict(b, q).numpy(), np.asarray(jsvr.predict(a, q)), rtol=PRED_REL)
        # the polish moved the solution by more than the tolerance
        moved = np.abs(b.beta.numpy() - b0.beta.numpy()).max()
        assert moved > BETA_REL * np.abs(beta_a).max()
        assert b.bias != b0.bias


def test_fit_many_ista_polish_same_shape_and_b1_view():
    """A same-shape batch (no padding) polishes each item as ``fit`` does."""
    rng = np.random.default_rng(3)
    sets = [_toy_set(rng, 24, scale=i + 1) for i in range(3)]
    kw = dict(ENGINE_KW, iters=20)
    batched = tsvr.fit_many(sets, device="cpu", **kw)
    ref = jsvr.fit_many(sets, **kw)
    for (x, y), mb, a in zip(sets, batched, ref):
        ms = tsvr.fit(x, y, device="cpu", **kw)
        np.testing.assert_allclose(ms.beta.numpy(), mb.beta.numpy(), rtol=1e-4, atol=1e-5)
        assert ms.bias == pytest.approx(mb.bias, abs=1e-5)
        np.testing.assert_allclose(
            tsvr.predict(mb, x).numpy(), np.asarray(jsvr.predict(a, x)), rtol=PRED_REL)


@pytest.mark.parametrize("shift,accepted", [(0.5, True), (1.5, False), (float("nan"), False)])
def test_polished_bias_is_kept_only_within_one_of_the_kkt_bias(monkeypatch, shift, accepted):
    """The polished bias replaces the active-set KKT bias only where it is
    finite and within 1.0 of it, in both packages: a bias recovery that
    lands ``shift`` away from the KKT bias is accepted at 0.5 and rejected
    at 1.5 or NaN."""
    import jax.numpy as jnp

    sets = _ista_case()
    n0 = len(sets[0][1])
    kkt_ref = [m.bias for m in jsvr.fit_many(sets, **ENGINE_KW)]
    kkt_port = [m.bias for m in tsvr.fit_many(sets, device="cpu", **ENGINE_KW)]

    def ref_recover(K, y, beta, C, eps, mask):  # one vmapped item, told apart by its rows
        kkt = jnp.where(jnp.sum(mask) == n0, jnp.float32(kkt_ref[0]), jnp.float32(kkt_ref[1]))
        return kkt + jnp.float32(shift)

    monkeypatch.setattr(jsvr, "_recover_bias_masked", ref_recover)
    monkeypatch.setattr(tsvr, "_recover_bias_batch", lambda K, y, beta, C, eps, mask:
                        torch.tensor(kkt_port, dtype=torch.float32) + shift)
    ref = jsvr.fit_many(sets, iters=10, **ENGINE_KW)
    port = tsvr.fit_many(sets, iters=10, device="cpu", **ENGINE_KW)
    for i, (a, b) in enumerate(zip(ref, port)):
        want_port, want_ref = kkt_port[i], kkt_ref[i]
        if accepted:
            want_port = float(np.float32(want_port) + np.float32(shift))
            want_ref = float(np.float32(want_ref) + np.float32(shift))
        assert b.bias == pytest.approx(want_port, abs=1e-6)
        assert a.bias == pytest.approx(want_ref, abs=1e-6)
        assert b.bias == pytest.approx(a.bias, abs=BIAS_ABS)
