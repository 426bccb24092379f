"""Port parity, kernels: ``repro_torch.kernels.ops`` on the CPU (the plain
PyTorch versions the Hopper kernels are held against on the card) against
the JAX package's Pallas kernels run in interpret mode, plus the dispatch
rules and the ``tpow`` rule.

Inputs are made from a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.plan_grid import pareto_mask_cuda, plan_argmin_cuda
from repro_torch.kernels.rbf_gram import rbf_gram_cuda

TIME_FLOOR = 1e-6
EPS32 = float(np.finfo(np.float32).eps)


def _rbf_tol(x, y, gamma):
    """Both sides compute xx + yy - 2 x·y in float32 but sum in different
    orders (XLA's dot vs the port's left-to-right sum), so d2 may differ by
    a few ulps of the larger of |x|^2 + |y|^2; K = exp(-gamma d2) then
    differs by at most gamma times that."""
    mag = float((x**2).sum(-1).max() + (y**2).sum(-1).max())
    return gamma * 8 * EPS32 * mag


@pytest.mark.parametrize(
    "shape,gamma,raw",
    [((1, 37, 29, 3), 0.5, True), ((3, 40, 64, 2), 0.5, False),
     ((2, 16, 130, 3), 1.3, False)],
)
def test_rbf_gram_matches_pallas_interpret(shape, gamma, raw):
    b, n, m, d = shape
    rng = np.random.default_rng(n * m + d)
    if raw:  # the paper's raw (f GHz, cores, input size) features
        def feats(k):
            return np.stack([rng.uniform(1.2, 2.2, (b, k)),
                             rng.integers(1, 33, (b, k)).astype(float),
                             rng.integers(1, 6, (b, k)).astype(float)], -1)
        x, y = feats(n).astype(np.float32), feats(m).astype(np.float32)
    else:
        x = rng.standard_normal((b, n, d)).astype(np.float32)
        y = rng.standard_normal((b, m, d)).astype(np.float32)
    tol = _rbf_tol(x, y, gamma)
    if b == 1:  # the 2-D form
        x, y = x[0], y[0]
    want = np.asarray(
        jops.rbf_gram(jnp.asarray(x), jnp.asarray(y), gamma, impl="pallas_interpret"))
    got = ops.rbf_gram(torch.from_numpy(x), torch.from_numpy(y), gamma)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_rbf_gram_diagonal_is_exactly_one():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((20, 3)).astype(np.float32))
    k = ops.rbf_gram(x, x, 0.5)
    assert float(k.max()) <= 1.0
    np.testing.assert_allclose(torch.diagonal(k).numpy(), 1.0, atol=4e-6)


def _sweep(b, g, seed, tie_every=0, mask_p=0.8):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1e-3, 2.0, (b, g)).astype(np.float32)
    w = rng.uniform(50.0, 5000.0, (1, g)).astype(np.float32)
    k = rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)
    mask = rng.random((b, g)) < mask_p
    if tie_every:
        t[:, ::tie_every] = t[:, 1::tie_every]
        w[:, ::tie_every] = w[:, 1::tie_every]
        mask[:, ::tie_every] = mask[:, 1::tie_every]
    return t, w, k, mask


def _argmin_both(t, w, k, mask):
    want = np.asarray(jops.plan_argmin(
        jnp.asarray(t), jnp.asarray(w), jnp.asarray(k),
        jnp.asarray(mask.astype(np.float32)), time_floor=TIME_FLOOR,
        impl="pallas_interpret"))
    got = ops.plan_argmin(
        torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(k),
        torch.from_numpy(mask), time_floor=TIME_FLOOR)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("b,g,k", [(9, 60, 0.0), (13, 128, 1.0), (40, 130, 2.0),
                                   (40, 352, None)])
def test_plan_argmin_matches_pallas_interpret(b, g, k):
    t, w, ks, mask = _sweep(b, g, seed=b * 1000 + g)
    if k is not None:
        ks[:] = k
    got, want = _argmin_both(t, w, ks, mask)
    np.testing.assert_array_equal(got, want)


def test_plan_argmin_ties_go_to_the_first_index():
    t, w, k, mask = _sweep(6, 64, seed=3, tie_every=2, mask_p=1.0)
    got, want = _argmin_both(t, w, k, mask)
    np.testing.assert_array_equal(got, want)
    assert (got % 2 == 0).all()


def test_plan_argmin_all_masked_row_returns_zero():
    t, w, k, mask = _sweep(5, 32, seed=9)
    mask[2] = False
    got, want = _argmin_both(t, w, k, mask)
    np.testing.assert_array_equal(got, want)
    assert got[2] == 0


def test_plan_argmin_floors_step_times():
    t, w, k, mask = _sweep(4, 16, seed=2, mask_p=1.0)
    t[:, 3] = -5.0  # floored to TIME_FLOOR: the cheapest point
    got, want = _argmin_both(t, w, k, mask)
    np.testing.assert_array_equal(got, want)
    assert (got == 3).all()


def test_plan_argmin_nan_step_times_follow_the_plain_reference():
    """A NaN step time survives the floor; the first feasible NaN metric
    wins, as ``jnp.argmin`` / ``np.argmin`` order NaN (the reference's
    plain version and its exact path). The reference's Pallas kernel
    returns G for such a row (its min is NaN and no lane equals it), so the
    port is held to the plain reference here."""
    t, w, k, mask = _sweep(6, 40, seed=11, mask_p=0.9)
    t[1, [7, 30]] = np.nan  # two feasible NaNs: the first one wins
    mask[1, [7, 30]] = True
    t[2, 5] = np.nan  # a masked NaN is +inf like any masked point
    mask[2, 5] = False
    t[3, :] = np.nan  # all NaN and feasible: index 0
    mask[3, :] = True
    want = np.asarray(jops.plan_argmin(
        jnp.asarray(t), jnp.asarray(w), jnp.asarray(k), jnp.asarray(mask),
        time_floor=TIME_FLOOR, impl="ref"))
    got = ops.plan_argmin(
        torch.from_numpy(t), torch.from_numpy(w), torch.from_numpy(k),
        torch.from_numpy(mask), time_floor=TIME_FLOOR).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 7 and got[3] == 0 and got[2] != 5


@pytest.mark.parametrize("b,g", [(1, 12), (5, 60), (9, 128), (4, 352)])
def test_pareto_mask_matches_pallas_interpret(b, g):
    rng = np.random.default_rng(b * 100 + g)
    t = rng.uniform(1e-3, 2.0, (b, g)).astype(np.float32)
    e = rng.uniform(1.0, 500.0, (b, g)).astype(np.float32)
    mask = rng.random((b, g)) < 0.8
    t[:, 5::7] = t[:, 4::7][:, : t[:, 5::7].shape[1]]  # exact (t, e) ties
    e[:, 5::7] = e[:, 4::7][:, : e[:, 5::7].shape[1]]
    t[0, 2], e[-1, 3] = np.inf, -np.inf
    t[-1, 1] = -np.inf
    want = np.asarray(jops.pareto_mask(
        jnp.asarray(t), jnp.asarray(e), jnp.asarray(mask.astype(np.float32)),
        impl="pallas_interpret"))
    got = ops.pareto_mask(torch.from_numpy(t), torch.from_numpy(e), torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_pareto_mask_chunks_rows_like_one_pass(monkeypatch):
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.uniform(0.1, 1.0, (7, 20)).astype(np.float32))
    e = torch.from_numpy(rng.uniform(1.0, 9.0, (7, 20)).astype(np.float32))
    m = torch.ones((7, 20), dtype=torch.bool)
    whole = ref.pareto_mask_ref(t, e, m)
    monkeypatch.setattr(ref, "_PARETO_ROWS_PER_CHUNK", 3)
    assert torch.equal(ref.pareto_mask_ref(t, e, m), whole)


def test_tpow_is_exact_for_the_engine_exponents():
    t = torch.from_numpy(
        np.random.default_rng(0).lognormal(0.0, 3.0, 100_000).astype(np.float32))
    assert torch.equal(ref.tpow(t, torch.tensor(2.0)), t * t)
    assert torch.equal(ref.tpow(t, torch.tensor(1.0)), t)
    assert torch.equal(ref.tpow(t, torch.tensor(0.0)), torch.ones_like(t))
    k = torch.tensor([0.0, 1.0, 2.0]).repeat(4)[:, None]
    tt = t[:1200].reshape(12, 100)
    want = torch.stack([torch.ones(100), tt[1], tt[2] * tt[2]])
    assert torch.equal(ref.tpow(tt, k)[:3], want)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = dict(ops.LAUNCHES)
    x = torch.zeros((4, 3))
    ops.rbf_gram(x, x, 0.5)
    t, w, k, mask = (torch.from_numpy(a) for a in _sweep(3, 8, seed=1))
    ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)
    ops.pareto_mask(t, t, mask)
    assert dict(ops.LAUNCHES) == before
    assert not ops.use_kernel(x) and not ops.use_kernel(x, "ref")


def test_dispatch_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.rbf_gram(torch.zeros((2, 2)), torch.zeros((2, 2)), 0.5, impl="pallas")


@pytest.mark.parametrize("which", ["rbf_gram", "plan_argmin", "pareto_mask"])
def test_cuda_wrappers_refuse_host_tensors(which):
    """A wrapper launches its kernel on CUDA tensors or raises; it never
    computes on the host."""
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "rbf_gram":
            rbf_gram_cuda(torch.zeros((1, 4, 3)), torch.zeros((1, 4, 3)), 0.5)
        elif which == "plan_argmin":
            plan_argmin_cuda(torch.zeros((2, 4)), torch.zeros((1, 4)), torch.zeros(2),
                             torch.ones((2, 4), dtype=torch.bool), time_floor=TIME_FLOOR)
        else:
            pareto_mask_cuda(torch.zeros((2, 4)), torch.zeros((2, 4)),
                             torch.ones((2, 4), dtype=torch.bool))
    assert dict(ops.LAUNCHES) == before


def test_build_inputs_and_failure_mode(monkeypatch):
    names = [p.name for p in _build.sources()]
    assert names == ["plan_grid.cu", "rbf_gram.cu"]
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "never-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("src", ["rbf_gram.cu", "plan_grid.cu"])
def test_cuda_sources_carry_their_note(src):
    text = (_build.CSRC / src).read_text()
    head = text[: text.index("#include")]
    assert "Replaces: src/repro/kernels/" in head
    assert "bounds it on an H100" in head
    assert "Design" in head
    assert "__expf" not in text  # the accurate expf, as the plain version


def test_reset_launches_zeroes_every_count():
    saved = dict(ops.LAUNCHES)
    try:
        ops.LAUNCHES["rbf_gram"] += 3
        ops.reset_launches()
        assert set(ops.LAUNCHES) == {"rbf_gram", "plan_argmin", "pareto_mask"}
        assert all(v == 0 for v in ops.LAUNCHES.values())
    finally:
        ops.LAUNCHES.update(saved)

