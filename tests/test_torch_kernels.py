"""Port parity, kernels: ``repro_torch.kernels.ops`` on the CPU (the plain
PyTorch versions the Hopper kernels are held against on the card) against
the JAX package's Pallas kernels run in interpret mode, plus the dispatch
rules and the ``tpow`` rule.

Inputs are made from a seed with numpy and handed to both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, launch_plan
from repro_torch.kernels.int8_codec import int8_dequantize_cuda, int8_quantize_cuda
from repro_torch.kernels.plan_grid import pareto_mask_cuda, plan_argmin_cuda
from repro_torch.kernels.rbf_gram import rbf_gram_cuda
from repro_torch.kernels.ssd_bwd import ssd_bwd_cuda
from repro_torch.kernels.ssd_scan import ssd_chunks_cuda

from test_torch_gpu import FLASH_CASES as GPU_FLASH_CASES

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


def _signed_zero_ties(b, g, seed):
    """Coarse values (many t and (t, e) ties), -0.0 beside +0.0 in t and in
    e, masked points and +-inf."""
    rng = np.random.default_rng(seed)
    t = np.round(rng.uniform(-1.0, 1.0, (b, g)), 1).astype(np.float32)
    e = np.round(rng.uniform(-2.0, 2.0, (b, g)), 1).astype(np.float32)
    for a in (t, e):
        a[rng.random((b, g)) < 0.15] = -0.0
        a[rng.random((b, g)) < 0.15] = 0.0
    t[:, 1], e[:, 1] = t[:, 0], e[:, 0]  # exact (t, e) ties
    t[0, :3], e[0, :3] = (-0.0, 0.0, 0.0), (1.0, 0.5, -0.0)
    t[rng.random((b, g)) < 0.03] = np.inf
    e[rng.random((b, g)) < 0.03] = -np.inf
    return t, e, rng.random((b, g)) < 0.85


@pytest.mark.parametrize("b,g", [(6, 40), (3, 352)])
def test_pareto_sort_rule_matches_the_reference_row_by_row(b, g):
    """The sort-and-running-minimum rule (``engine.pareto_frontier``, and
    the sort path of csrc/plan_grid.cu) against the reference's pairwise
    predicate: its plain version and its Pallas kernel in interpret mode,
    with -0.0 == +0.0 and exact ties keeping the lowest flat index."""
    from repro.kernels.plan_grid import pareto_mask_pallas
    from repro_torch.core.engine import pareto_frontier

    t, e, mask = _signed_zero_ties(b, g, seed=b + g)
    plain = ref.pareto_mask_ref(torch.from_numpy(t), torch.from_numpy(e),
                                torch.from_numpy(mask)).numpy()
    pallas = np.asarray(pareto_mask_pallas(jnp.asarray(t), jnp.asarray(e),
                                           jnp.asarray(mask.astype(np.float32)),
                                           interpret=True)).astype(bool)
    np.testing.assert_array_equal(plain, pallas)
    for r in range(b):
        frontier = pareto_frontier(np.where(mask[r], t[r], np.inf), e[r])
        keep = np.zeros(g, bool)
        keep[[i for (i,) in frontier]] = True
        np.testing.assert_array_equal(keep, plain[r], err_msg=f"row {r}")
    assert plain[0, 1] != plain[0, 0] or not plain[0, 0]  # a tie keeps one at most


def test_pareto_plan_takes_the_sort_up_to_its_capacity():
    from repro_torch.kernels.plan_grid import PARETO_SORT_SLOTS, pareto_plan

    assert pareto_plan(10_000, 352) == pareto_plan(1, 352)  # B does not change the path
    assert (pareto_plan(10_000, 352).path, pareto_plan(10_000, 352).slots) == ("sort", 512)
    for g, slots in ((1, 128), (128, 128), (129, 256), (256, 256), (513, 1024),
                     (1024, 1024)):
        plan = pareto_plan(7, g)
        assert (plan.path, plan.slots) == ("sort", slots)
    for g in (1025, 1500, 100_000):
        assert (pareto_plan(7, g).path, pareto_plan(7, g).slots) == ("pairs", 0)
    assert PARETO_SORT_SLOTS[-1] == 1024


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
    q = torch.zeros((1, 2, 3, 16))
    ops.flash_attention(q, q, q)
    xs, dts, A, B, C = (torch.from_numpy(a) for a in _ssd_inputs(1, 20, 2, 4, 1, 8, seed=0))
    ops.ssd_scan(xs, dts, A, B, C, chunk=16)
    ops.ssd_scan_chunked(xs, dts, A, B, C, chunk=16)
    qq, sc = ops.int8_quantize(torch.ones(300))
    ops.int8_dequantize(qq, sc, n=300)
    assert dict(ops.LAUNCHES) == before
    assert not ops.use_kernel(x) and not ops.use_kernel(x, "ref")


def test_dispatch_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.rbf_gram(torch.zeros((2, 2)), torch.zeros((2, 2)), 0.5, impl="pallas")


@pytest.mark.parametrize(
    "which", ["rbf_gram", "plan_argmin", "pareto_mask", "flash_attention", "ssd_chunks",
              "int8_quantize", "int8_dequantize"])
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
        elif which == "pareto_mask":
            pareto_mask_cuda(torch.zeros((2, 4)), torch.zeros((2, 4)),
                             torch.ones((2, 4), dtype=torch.bool))
        elif which == "flash_attention":
            q = torch.zeros((1, 2, 4, 16))
            flash_attention_cuda(q, q, q, causal=True, window=None, scale=None,
                                 q_offset=0, kv_len=None)
        elif which == "int8_quantize":
            int8_quantize_cuda(torch.zeros(300))
        elif which == "int8_dequantize":
            int8_dequantize_cuda(torch.zeros(512, dtype=torch.int8), torch.ones(2), n=300)
        else:
            ssd_chunks_cuda(torch.zeros((2, 1, 16, 8)), torch.zeros((2, 1, 16)),
                            torch.zeros((2, 1, 16)), torch.zeros((1, 16, 1, 4)),
                            torch.zeros((1, 16, 1, 4)), heads=2)
    assert dict(ops.LAUNCHES) == before


def _ssd_bwd_args(bh=2, nc=1, T=16, p=8, b=1, g=1, n=4):
    f = torch.zeros
    return dict(x=f((bh, nc, T, p)), dt=f((bh, nc, T)), a=f((bh, nc, T)), A=f((bh,)),
                B=f((b, nc * T, g, n)), C=f((b, nc * T, g, n)), H=f((bh, nc, n, p)),
                dy=f((bh, nc, T, p)), d_final=None)


@pytest.mark.parametrize("fault", ["host", "dtype", "strided"])
def test_ssd_bwd_wrapper_refuses_what_the_kernel_does_not_take(fault):
    """As ``attention_bwd_cuda``: a host tensor, a dtype other than f32 or
    a non-contiguous input raises ``ValueError`` before any launch (the
    dtype and the layout are checked before the device, so each fault is
    named on the host)."""
    args = _ssd_bwd_args()
    match = "CUDA tensor"
    if fault == "dtype":
        args["dy"], match = args["dy"].double(), "float32"
    elif fault == "strided":
        args["dy"], match = torch.zeros((2, 1, 8, 16)).transpose(-1, -2), "contiguous"
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ssd_bwd_cuda(**args, heads=2)
    assert dict(ops.LAUNCHES) == before


def test_ssd_scan_backward_on_the_host_is_the_plain_vjp():
    """A CPU tensor's SSD backward is the VJP of the plain scan: the graph
    saves the inputs only (no entry states), no kernel is counted, and its
    gradients equal autograd through ``ref.ssd_scan_ref`` bit for bit."""
    arrs = _ssd_inputs(2, 40, 4, 8, 2, 16, seed=5)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 40, 4, 8))
                         .astype(np.float32))
    got, want = ([torch.from_numpy(a).requires_grad_(True) for a in arrs] for _ in range(2))
    before = dict(ops.LAUNCHES)
    y = ops.ssd_scan(*got, chunk=16)
    assert len(y.grad_fn.saved_tensors) == 6
    (y * w).sum().backward()
    assert dict(ops.LAUNCHES) == before
    (ref.ssd_scan_ref(*want, chunk=16) * w).sum().backward()
    for a, b in zip(got, want):
        assert torch.equal(a.grad, b.grad)


def test_ssd_head_slice_fills_the_card_in_the_fewest_waves():
    from repro_torch.kernels.ssd_scan import MAX_HEAD_SLICE, head_slice

    # mamba2-130m at prefill (b 8 x 8 chunks) and training (b 2 x 32
    # chunks), one group of 24 heads: 128 blocks of 12 heads, one wave of
    # the H100's 132 SMs (slices of 4, 6 and 8 measured slower there)
    assert head_slice(64, 24) == 12
    assert head_slice(64, 21) == 11  # 11 + 10 heads
    assert head_slice(4, 6) == 1  # few blocks: a head a block fills more SMs
    assert head_slice(10**6, 64) == MAX_HEAD_SLICE  # many waves: the largest slice
    for blocks, heads, sms in [(64, 24, 132), (3, 7, 132), (1000, 48, 114), (64, 1, 132)]:
        got = head_slice(blocks, heads, sms)
        assert 1 <= got <= min(heads, MAX_HEAD_SLICE)


def test_build_inputs_and_failure_mode(monkeypatch):
    names = [p.name for p in _build.sources()]
    assert names == ["attention_bwd.cu", "flash_attention.cu", "int8_codec.cu", "plan_grid.cu",
                     "rbf_gram.cu", "ssd_bwd.cu", "ssd_scan.cu"]
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "never-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize(
    "src", ["rbf_gram.cu", "plan_grid.cu", "flash_attention.cu", "ssd_scan.cu",
            "int8_codec.cu"])
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
        assert set(ops.LAUNCHES) == {"rbf_gram", "plan_argmin", "pareto_mask",
                                     "flash_attention", "ssd_chunks", "int8_quantize",
                                     "int8_dequantize", "attention_bwd", "ssd_bwd"}
        assert all(v == 0 for v in ops.LAUNCHES.values())
    finally:
        ops.LAUNCHES.update(saved)



# ---------------------------------------------------------------------------
# flash attention: the plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (2, 4, 4, 64, 32, True, None),  # MHA
    (2, 4, 2, 67, 32, True, None),  # GQA, ragged S
    (1, 8, 1, 128, 64, True, None),  # MQA
    (2, 4, 2, 80, 32, True, 16),  # sliding window
    (2, 4, 4, 48, 32, False, None),  # bidirectional
]


def _qkv(b, h, hk, sq, skv, d, seed, np_dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np_dtype),
            rng.standard_normal((b, hk, skv, d)).astype(np_dtype),
            rng.standard_normal((b, hk, skv, d)).astype(np_dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hk,s,d,causal,window", FLASH_CASES)
def test_flash_attention_matches_pallas_interpret(b, h, hk, s, d, causal, window, dtype):
    q, k, v = _qkv(b, h, hk, s, s, d, seed=s * 10 + h)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal=causal,
        window=window, block_q=32, block_k=32, impl="pallas_interpret"), np.float32)
    got = ref.flash_attention_ref(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
        causal=causal, window=window, block_q=32, block_k=32)
    assert got.dtype == td and tuple(got.shape) == want.shape
    # the tolerance of the reference's own kernel test: f32 sums in another
    # order; bf16 rounds the output (2^-7 relative at |out| ~ 1)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("window,L,idx", [(None, 40, 25), (8, 40, 25), (8, 8, 30)])
def test_flash_attention_decode_form_matches_reference(window, L, idx):
    """Decode: one query at position idx against a cache of L slots, as
    ``models/attention.decode_step`` calls it (global: q_offset idx, kv_len
    idx + 1; ring of the window: q_offset 0, kv_len min(idx + 1, L))."""
    q, k, v = _qkv(2, 4, 2, 1, L, 16, seed=idx + L)
    if window is None:
        kw = dict(causal=False, window=None, q_offset=idx, kv_len=idx + 1)
    else:
        kw = dict(causal=False, window=None, q_offset=0, kv_len=min(idx + 1, L))
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    naive = ref.mha_naive_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    np.testing.assert_allclose(naive.numpy(), want, rtol=0, atol=2e-6)


def test_flash_attention_plain_version_is_the_same_at_any_chunking():
    """One kv chunk or many (the running max / sum carried across them):
    the same function, in ops's default chunking and the naive oracle."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 70, 70, 16, seed=7))
    want = ref.mha_naive_ref(q, k, v, causal=True, window=24)
    for bq, bk in [(16, 16), (32, 16), (70, 70), (128, 128)]:
        got = ref.flash_attention_ref(q, k, v, causal=True, window=24, block_q=bq, block_k=bk)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(ops.flash_attention(q, k, v, causal=True, window=24), want,
                               rtol=0, atol=2e-6)


def test_flash_attention_fully_masked_rows_give_zero():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 6, 12, 16, seed=5))
    out = ops.flash_attention(q, k, v, causal=True, window=4, q_offset=10, kv_len=9)
    # row i sits at 10 + i and sees keys 7 + i .. 10 + i below 9: rows 0, 1 only
    assert out[:, :, 2:].abs().max() == 0
    assert out[:, :, :2].abs().min() > 0
    assert ops.flash_attention(q, k, v, kv_len=0).abs().max() == 0


# ---------------------------------------------------------------------------
# SSD: the plain versions against the reference's Pallas chunk kernel
# ---------------------------------------------------------------------------


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


SSD_CASES = [(64, 16, 1), (64, 16, 2), (100, 32, 1), (100, 32, 2), (32, 32, 1), (32, 32, 2)]


@pytest.mark.parametrize("s,chunk,g", SSD_CASES)
def test_ssd_scan_matches_pallas_interpret(s, chunk, g):
    """``ops.ssd_scan`` on the host (the plain ``ssd_scan_ref``) and
    ``ops.ssd_scan_chunked`` (the kernel's wrapper around the plain chunk
    block) against the reference's Pallas chunk kernel, at the reference
    kernel test's shapes (s not a multiple of the chunk included)."""
    arrs = _ssd_inputs(2, s, 4, 8, g, 16, seed=s + chunk + g)
    want_y, want_h = jops.ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                                   return_state=True, impl="pallas_interpret")
    want_y, want_h = np.asarray(want_y), np.asarray(want_h)
    t = [torch.from_numpy(a) for a in arrs]
    # f32 sums over T and n in another order: the reference test's 2e-4
    # against its naive loop, here against its kernel
    for fn in (ops.ssd_scan, ops.ssd_scan_chunked):
        y, hs = fn(*t, chunk=chunk, return_state=True)
        np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=2e-4)
        np.testing.assert_allclose(hs.numpy(), want_h, rtol=0, atol=2e-4)


def test_ssd_chunks_plain_matches_the_reference_kernel_body():
    """The plain chunk block (B and C per group) against
    ``ssd_chunks_pallas`` in interpret mode on B and C repeated to heads, as
    the reference's wrapper feeds it."""
    from repro.kernels.ssd_scan import ssd_chunks_pallas

    b, h, g, nc, T, p, n = 2, 4, 2, 3, 16, 8, 16
    x, dt, A, B, C = _ssd_inputs(b, nc * T, h, p, g, n, seed=11)
    xc = np.moveaxis(x, 2, 1).reshape(b * h, nc, T, p)
    dtc = np.moveaxis(dt, 2, 1).reshape(b * h, nc, T)
    a = (dtc * np.tile(A, b)[:, None, None]).astype(np.float32)
    rep = h // g
    Bh = np.moveaxis(np.repeat(B, rep, axis=2), 2, 1).reshape(b * h, nc, T, n)
    Ch = np.moveaxis(np.repeat(C, rep, axis=2), 2, 1).reshape(b * h, nc, T, n)
    want = ssd_chunks_pallas(*(jnp.asarray(v) for v in (xc, dtc, a, Bh, Ch)), chunk=T,
                             interpret=True)
    got = ops.ssd_chunks(*(torch.from_numpy(np.ascontiguousarray(v))
                           for v in (xc, dtc, a, B, C)), heads=h)
    for gt, wt in zip(got, want):
        wt = np.asarray(wt)
        assert tuple(gt.shape) == wt.shape
        np.testing.assert_allclose(gt.numpy(), wt, rtol=1e-5, atol=1e-5 * np.abs(wt).max())


def test_ssm_decode_step_matches_reference():
    b, h, p, g, n = 2, 4, 8, 2, 16
    rng = np.random.default_rng(3)
    hs = rng.normal(size=(b, h, n, p)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, g, n)).astype(np.float32)
    C = rng.normal(size=(b, g, n)).astype(np.float32)
    args = (hs, x, dt, A, B, C)
    want_h, want_y = jops.ssm_decode_step(*(jnp.asarray(v) for v in args))
    got_h, got_y = ops.ssm_decode_step(*(torch.from_numpy(v) for v in args))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# gradients: the autograd wrappers of flash attention and the SSD scan
# against jax.grad through the reference's custom VJPs
# ---------------------------------------------------------------------------

# (b, h, hk, sq, d, causal, window, block): causal, window, GQA 6/2, ragged
# sq with small blocks
FLASH_GRAD_CASES = [
    (2, 4, 4, 40, 16, True, None, 512),
    (1, 4, 2, 48, 16, True, 12, 512),
    (1, 6, 2, 37, 16, True, None, 512),
    (2, 6, 2, 67, 32, True, None, 16),
    (1, 4, 2, 45, 16, False, None, 16),
]


@pytest.mark.parametrize("b,h,hk,s,d,causal,window,block", FLASH_GRAD_CASES)
def test_flash_attention_gradients_match_reference(b, h, hk, s, d, causal, window, block):
    import jax

    q, k, v = _qkv(b, h, hk, s, s, d, seed=s + h + d)
    w = np.random.default_rng(s).standard_normal((b, h, s, d)).astype(np.float32)
    kw = dict(causal=causal, window=window)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, impl="ref", block_q=block,
                                            block_k=block, **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = dict(ops.LAUNCHES)
    if block == 512:
        out = ops.flash_attention(tq, tk, tv, **kw)
    else:  # the plain backward at the reference's small blocks
        out = ops._FlashAttention.apply(tq, tk, tv, dict(kw, scale=None, q_offset=0,
                                                         kv_len=None), "ref")
        dq, dk, dv = ref.flash_attention_bwd_ref(
            tq.detach(), tk.detach(), tv.detach(),
            *ref.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(), return_lse=True,
                                     block_q=block, block_k=block, **kw),
            torch.from_numpy(w), block_q=block, block_k=block, **kw)
        for g, wt in zip((dq, dk, dv), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=0, atol=2e-5)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    assert dict(ops.LAUNCHES) == before
    # f32 sums over the kv chunks in another order
    for t, wt in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wt), rtol=0, atol=2e-5)


def test_flash_attention_lse_matches_reference():
    q, k, v = _qkv(1, 4, 2, 45, 45, 16, seed=9)
    _, want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       window=8, block_q=16, block_k=16, return_lse=True)
    out, lse = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=8,
                                       block_q=16, block_k=16, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    _, none = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=0,
                                      return_lse=True)
    assert torch.isneginf(none).all()


@pytest.mark.parametrize("s,chunk,g", [(64, 16, 1), (50, 16, 2), (40, 32, 1)])
def test_ssd_scan_gradients_match_reference(s, chunk, g):
    """s not a multiple of the chunk included."""
    import jax

    arrs = _ssd_inputs(2, s, 4, 8, g, 16, seed=s * 3 + g)
    w = np.random.default_rng(s).standard_normal((2, s, 4, 8)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jops.ssd_scan(*a, chunk=chunk, impl="ref") * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in arrs))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y = ops.ssd_scan(*t, chunk=chunk)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    (y * torch.from_numpy(w)).sum().backward()
    for name, a, wt in zip("x dt A B C".split(), t, want):
        wt = np.asarray(wt)
        # f32 sums over chunk and state in another order, relative to scale
        np.testing.assert_allclose(a.grad.numpy(), wt, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(wt).max()), err_msg=name)


SSD_H0_CASES = [(64, 16, 1), (50, 16, 2), (100, 32, 1)]


def _ssd_h0(seed):
    return np.random.default_rng(seed).normal(size=(2, 4, 16, 8)).astype(np.float32)


@pytest.mark.parametrize("s,chunk,g", SSD_H0_CASES)
def test_ssd_scan_with_h0_matches_reference(s, chunk, g):
    """``ops.ssd_scan(h0=)`` (the plain scan) and ``ssd_scan_chunked(h0=)``
    (the kernel's wrapper around the plain chunk block) against the
    reference's ``ops.ssd_scan(h0=)`` (its jnp scan) and its Pallas path
    ``_ssd_pallas_impl(h0=)`` in interpret mode, s not a multiple of the
    chunk included."""
    from repro.kernels.ops import _ssd_pallas_impl

    arrs = _ssd_inputs(2, s, 4, 8, g, 16, seed=s + chunk + 7 * g)
    h0 = _ssd_h0(s + g)
    jarrs = [jnp.asarray(a) for a in arrs]
    wants = [jops.ssd_scan(*jarrs, chunk=chunk, h0=jnp.asarray(h0), return_state=True),
             _ssd_pallas_impl(*jarrs, chunk=chunk, h0=jnp.asarray(h0), return_state=True,
                              interpret=True)]
    t = [torch.from_numpy(a) for a in arrs]
    for fn in (ops.ssd_scan, ops.ssd_scan_chunked):
        y, hs = fn(*t, chunk=chunk, h0=torch.from_numpy(h0), return_state=True)
        y0 = fn(*t, chunk=chunk)
        assert not torch.allclose(y, y0)  # the initial state reached the output
        for want_y, want_h in wants:
            # f32 sums over T and n in another order, as the h0-free test
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0, atol=2e-4)
            np.testing.assert_allclose(hs.numpy(), np.asarray(want_h), rtol=0, atol=2e-4)


@pytest.mark.parametrize("s,chunk,g", SSD_H0_CASES)
def test_ssd_scan_gradients_with_h0_match_reference(s, chunk, g):
    """The gradient of every input, h0 included, through ``_SSDScan``'s
    plain VJP against ``jax.vjp`` of the reference's ``ssd_scan_ref``, with
    cotangents on y and on the final state."""
    import jax

    arrs = _ssd_inputs(2, s, 4, 8, g, 16, seed=s * 5 + g)
    h0 = _ssd_h0(s * 5 + g)
    rng = np.random.default_rng(s + 1)
    gy = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    gh = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)

    def jf(x, dt, A, B, C, h0):
        return jref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk, h0=h0, return_state=True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (*arrs, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (*arrs, h0)]
    y, hs = ops.ssd_scan(*t[:5], chunk=chunk, h0=t[5], return_state=True)
    assert "SSDScan" in type(y.grad_fn).__name__
    torch.autograd.backward([y, hs], [torch.from_numpy(gy), torch.from_numpy(gh)])
    for name, a, wt in zip("x dt A B C h0".split(), t, want):
        wt = np.asarray(wt)
        # f32 sums over chunk and state in another order, relative to scale
        np.testing.assert_allclose(a.grad.numpy(), wt, rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(wt).max()), err_msg=name)


def test_kernel_wrappers_skip_autograd_without_grad():
    """Serving (no input needs a gradient) calls the kernels bare, so the
    serving paths' launch counts stay as they were."""
    q = torch.zeros((1, 2, 3, 16))
    assert ops.flash_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        qg = q.clone().requires_grad_(True)
        assert ops.flash_attention(qg, q, q).grad_fn is None


@pytest.mark.parametrize("impl", [None, "ref"])
def test_flash_backward_recomputes_through_the_forward_dispatch(impl):
    """The backward recomputes (out, lse) through the forward's dispatch: on
    the CPU that is the plain version for both impls, so the gradients are
    jax.grad through the reference's ``_flash_vjp`` (GQA 6/2, a window, a
    query offset and kv_len below skv), and nothing launches."""
    import jax

    q, k, v = _qkv(1, 6, 2, 20, 33, 16, seed=21)
    w = np.random.default_rng(22).standard_normal((1, 6, 20, 16)).astype(np.float32)
    kw = dict(causal=True, window=10, scale=None, q_offset=13, kv_len=30)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, impl="ref", **kw) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = dict(ops.LAUNCHES)
    out = ops._FlashAttention.apply(*leaves, kw, impl)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    assert dict(ops.LAUNCHES) == before
    # f32 sums over the kv chunks in another order
    for t, wt in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wt), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# the flash kernel's launch plan: which path of csrc/flash_attention.cu a
# call takes (the tile sizes, key splits and scratch the kernel assumes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GPU_FLASH_CASES)
def test_flash_launch_plan_of_every_kernel_case(case, dtype):
    b, h, hk, sq, skv, d, causal, window, q_offset, kv_len = case
    plan = launch_plan(b, h, hk, sq, skv, d, dtype, kv_len)
    if dtype == torch.float32:
        assert plan.path == ("fma_row" if sq < 16 else "fma_tile")
        assert plan.scratch_shape == () and plan.splits == 1
    elif sq >= 16:
        assert plan.path == "mma_tile" and (plan.rows, plan.tile_k) == (64, 64)
        assert plan.scratch_shape == () and plan.splits == 1
    else:
        packed = h // hk * sq
        assert plan.path == "mma_decode" and plan.tile_k == 64
        # the smallest of 16, 32, 64 rows that holds the packed rows, at most
        # 64 (32 at d 256)
        cap = 32 if d > 128 else 64
        assert plan.rows == min(r for r in (16, 32, 64) if r >= min(packed, cap))
        key_tiles = max(1, math.ceil((skv if kv_len is None else kv_len) / 64))
        assert 1 <= plan.splits <= key_tiles
        assert b * hk * plan.splits >= 264 or plan.splits == key_tiles
        assert plan.scratch_shape == (b, hk, packed, plan.splits, d + 2)


def test_flash_launch_plan_at_starcoder2_shapes():
    for sq in (1024, 4096):  # prefill (b 8) and training (b 2)
        plan = launch_plan(8 if sq == 1024 else 2, 24, 2, sq, sq, 128, torch.bfloat16)
        assert (plan.path, plan.rows, plan.tile_k, plan.scratch_shape) == ("mma_tile", 64, 64, ())
    # a decode step: the 12 query heads of a kv group packed into one
    # 16-row tile; 16 (b, kv head) pairs need 17 splits for 264 blocks, and
    # the cache has 17 key tiles
    decode = launch_plan(8, 24, 2, 1, 1064, 128, torch.bfloat16, kv_len=1056)
    assert decode.path == "mma_decode" and decode.rows == 16 and decode.splits == 17
    assert decode.scratch_shape == (8, 2, 12, 17, 130)
    # another card's SM count; a short cache caps the splits at its key tiles
    assert launch_plan(8, 24, 2, 1, 1064, 128, torch.bfloat16, 1056, sms=114).splits == 15
    assert launch_plan(1, 24, 2, 1, 100, 128, torch.bfloat16).splits == 2
    # SMOKE width (f32) takes the FMA kernels
    assert launch_plan(2, 3, 1, 40, 40, 16, torch.float32).path == "fma_tile"
    assert launch_plan(2, 3, 1, 1, 40, 16, torch.float32).path == "fma_row"


def test_flash_launch_plan_at_gemma3_shapes():
    """Head dim 256 (gemma3-12b: 16 heads over 8 kv heads): the wgmma tiles
    at prefill, GQA-packed decode with d + 2 scratch columns, and the f32
    tile kernel's key tile halved to 16."""
    prefill = launch_plan(1, 16, 8, 4096, 4096, 256, torch.bfloat16)
    assert (prefill.path, prefill.rows, prefill.tile_k) == ("mma_tile", 64, 64)
    decode = launch_plan(1, 16, 8, 1, 4096, 256, torch.bfloat16, kv_len=4096)
    # 2 packed rows a kv group in a 16-row tile; 8 (b, kv head) pairs need
    # 33 splits for 264 blocks, and the cache has 64 key tiles
    assert (decode.path, decode.rows, decode.splits) == ("mma_decode", 16, 33)
    assert decode.scratch_shape == (1, 8, 2, 33, 258)
    # more packed rows than 32 take 32-row blocks at d 256 (64 at d 128)
    assert launch_plan(1, 16, 1, 4, 130, 256, torch.bfloat16).rows == 32
    assert launch_plan(1, 16, 1, 4, 130, 128, torch.bfloat16).rows == 64
    for d, tile_k in ((256, 16), (128, 32)):
        plan = launch_plan(1, 16, 8, 40, 40, d, torch.float32)
        assert (plan.path, plan.rows, plan.tile_k) == ("fma_tile", 64, tile_k)
    assert launch_plan(1, 16, 8, 3, 40, 256, torch.float32).path == "fma_row"


@pytest.mark.parametrize("d", [8, 48, 80, 192, 320])
def test_flash_attention_refuses_head_dims_without_an_instance(d):
    """Head dims other than 16, 32, 64, 128, 256 (and 96, 112, padded) raise
    before anything else is checked or launched."""
    before = dict(ops.LAUNCHES)
    q = torch.zeros((1, 2, 4, d))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q, causal=True, window=None, scale=None, q_offset=0,
                             kv_len=None)
    assert dict(ops.LAUNCHES) == before


# ---------------------------------------------------------------------------
# int8 codec: the plain version against the reference's, bit for bit
# ---------------------------------------------------------------------------


def _codec_input(n, seed):
    x = (np.random.default_rng(seed).standard_normal(n) * 3.0).astype(np.float32)
    return x


def _edge_input():
    """Blocks of: zeros; a NaN; +inf; -inf; half-way values at scale 1 (amax
    127: 0.5, 1.5, 2.5, -2.5 round to 0, 2, 2, -2); ties at scale 0.5; a
    ragged tail of 100."""
    blocks = [np.zeros(256, np.float32)]
    b = _codec_input(256, 1); b[17] = np.nan; blocks.append(b)
    b = _codec_input(256, 2); b[3] = np.inf; blocks.append(b)
    b = _codec_input(256, 3); b[200] = -np.inf; blocks.append(b)
    b = np.zeros(256, np.float32); b[0] = 127.0
    b[1:9] = [0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5, 3.5]; blocks.append(b)
    b = np.zeros(256, np.float32); b[0] = 63.5; b[1:5] = [0.25, 0.75, -1.25, 1e-30]
    blocks.append(b)
    blocks.append(_codec_input(100, 4))
    return np.concatenate(blocks)


CODEC_CASES = [("n", 1), ("n", 255), ("n", 256), ("n", 1000), ("n", 16384), ("n", 70001),
               ("edge", 0)]


@pytest.mark.parametrize("kind,n", CODEC_CASES)
def test_int8_codec_matches_reference_bit_for_bit(kind, n):
    from repro.kernels.int8_codec import int8_dequantize_pallas, int8_quantize_pallas

    x = _edge_input() if kind == "edge" else _codec_input(n, n)
    n = x.size
    nb = -(-n // 256)
    import jax

    # the reference as it runs in its train step: jitted, where XLA takes
    # amax / 127 as amax * f32(1/127)
    want_q, want_s = (np.asarray(a) for a in jax.jit(jref.int8_quantize_ref)(jnp.asarray(x)))
    got_q, got_s = ops.int8_quantize(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and tuple(got_q.shape) == (nb * 256,)
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (nb,)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s.view(np.uint32))
    # called eagerly, jnp divides: scales within one ulp of the port's
    _, eager_s = (np.asarray(a) for a in jref.int8_quantize_ref(jnp.asarray(x)))
    ulps = np.abs(got_s.numpy().view(np.int32).astype(np.int64) - eager_s.view(np.int32))
    assert ulps.max() <= 1
    # the Pallas kernel pads to 64-block row groups: its first nb blocks
    pal_q, pal_s = (np.asarray(a) for a in int8_quantize_pallas(jnp.asarray(x),
                                                                 interpret=True))
    np.testing.assert_array_equal(got_q.numpy(), pal_q[: nb * 256])
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  pal_s[:nb].view(np.uint32))
    want_x = np.asarray(jref.int8_dequantize_ref(jnp.asarray(want_q), jnp.asarray(want_s), n))
    got_x = ops.int8_dequantize(got_q, got_s, n=n)
    assert tuple(got_x.shape) == (n,)
    np.testing.assert_array_equal(got_x.numpy().view(np.uint32), want_x.view(np.uint32))
    pal_x = np.asarray(int8_dequantize_pallas(jnp.asarray(pal_q), jnp.asarray(pal_s), n=n,
                                              interpret=True))
    np.testing.assert_array_equal(got_x.numpy().view(np.uint32), pal_x.view(np.uint32))


def test_int8_codec_edge_blocks_follow_the_reference_rules():
    x = _edge_input()
    q, s = ops.int8_quantize(torch.from_numpy(x))
    q, s = q.numpy().reshape(-1, 256), s.numpy()
    assert s[0] == 1.0 and not q[0].any()  # zero block: scale 1
    assert s[1] == 1.0 and q[1, 17] == 0  # NaN block: scale 1, the NaN gives 0
    assert np.isinf(s[2]) and np.isinf(s[3]) and not q[2].any() and not q[3].any()
    assert s[4] == 1.0 and list(q[4, :9]) == [127, 0, 2, 2, -2, 0, 126, -126, 4]
    assert (np.abs(q) <= 127).all()
