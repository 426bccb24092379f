"""The Hopper kernels on the card, against their plain versions, at small
shapes. Marked ``gpu``: they skip without a CUDA device. On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no ``jax``: the card's machine has none.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

TIME_FLOOR = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels have no host mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 37, 29, 3), (3, 40, 64, 2), (2, 100, 33, 16)])
def test_rbf_gram_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels import ops

    b, n, m, d = shape
    rng = np.random.default_rng(n + m)
    x = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((b, m, d)).astype(np.float32)).to(cuda)
    if b == 1:
        x, y = x[0], y[0]
    before = ops.LAUNCHES["rbf_gram"]
    got = ops.rbf_gram(x, y, 0.5)
    want = ops.rbf_gram(x, y, 0.5, impl="ref")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rbf_gram"] == before + 1
    # same expression and summation order; expf on both sides
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("m", [1, 3, 5, 1761])
def test_rbf_gram_kernel_takes_ragged_columns(cuda, m, d):
    """One x row against m columns: m % 4 != 0 leaves a scalar tail, and
    m = 5 or 1761 puts rows off 16-byte alignment."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(m * 17 + d)
    x = torch.from_numpy(rng.standard_normal((2, 1, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((2, m, d)).astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["rbf_gram"]
    got = ops.rbf_gram(x, y, 0.5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rbf_gram"] == before + 1
    torch.testing.assert_close(got, ops.rbf_gram(x, y, 0.5, impl="ref"), rtol=0, atol=2e-6)
    # and m rows against m columns, every row's alignment in turn
    xm = y[:, : min(m, 67)]
    torch.testing.assert_close(ops.rbf_gram(xm, y, 0.5), ops.rbf_gram(xm, y, 0.5, impl="ref"),
                               rtol=0, atol=2e-6)


def test_rbf_gram_kernel_rejects_wide_features(cuda):
    from repro_torch.kernels import ops

    x = torch.zeros((4, 17), device=cuda)
    with pytest.raises(ValueError, match="feature dim"):
        ops.rbf_gram(x, x, 0.5)


# G % 4 == 0 and not, G < 32, the engine's 352, 1,024 and 1,028, B = 1,
# and B = 10,007 (several rows a warp of the persistent grid, not a multiple
# of its warps)
@pytest.mark.parametrize("b,g", [(1, 7), (33, 352), (300, 130), (300, 128), (1, 352),
                                 (17, 12), (17, 4), (5, 1), (10_007, 352), (10_007, 350),
                                 (64, 1024), (64, 1028)])
def test_plan_argmin_kernel_matches_plain(cuda, b, g):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(b + g)
    t = rng.lognormal(0.0, 1.0, (b, g)).astype(np.float32)
    w = rng.uniform(50.0, 600.0, (1, g)).astype(np.float32)
    k = rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)
    mask = rng.random((b, g)) < 0.7
    t[:, 1::2] = t[:, 0::2][:, : t[:, 1::2].shape[1]]  # exact ties
    w[:, 1::2] = w[:, 0::2][:, : w[:, 1::2].shape[1]]
    mask[::5] = False  # all-masked rows
    t[1::7, g // 2] = np.nan  # NaN step times, feasible or masked
    t[2::7, :] = np.nan
    mask[2::7, :] = True  # all-NaN feasible rows
    args = [torch.from_numpy(a).to(cuda) for a in (t, w, k, mask)]
    before = ops.LAUNCHES["plan_argmin"]
    got = ops.plan_argmin(*args, time_floor=TIME_FLOOR)
    want = ops.plan_argmin(*args, time_floor=TIME_FLOOR, impl="ref")
    assert ops.LAUNCHES["plan_argmin"] == before + 1
    assert torch.equal(got, want)
    assert (got[::5] == 0).all()


@pytest.mark.parametrize("g", [352, 128])
def test_plan_argmin_kernel_takes_unaligned_inputs(cuda, g):
    """t four bytes and the mask one byte past their alignment (slices of a
    larger buffer): the plain version's indices, and the aligned copy's."""
    from repro_torch.kernels import ops

    b = 257
    rng = np.random.default_rng(g)
    t_buf = torch.from_numpy(rng.lognormal(0.0, 1.0, b * g + 1).astype(np.float32)).to(cuda)
    m_buf = torch.from_numpy(rng.random(b * g + 1) < 0.6).to(cuda)
    t = t_buf[1:].view(b, g)
    mask = m_buf[1:].view(b, g)
    w = torch.from_numpy(rng.uniform(50.0, 600.0, (1, g)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)).to(cuda)
    mask[::3] = False
    assert t.is_contiguous() and t.data_ptr() % 16 == 4
    got = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)
    want = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl="ref")
    assert torch.equal(got, want)
    assert torch.equal(
        ops.plan_argmin(t.clone(), w, k, mask.clone(), time_floor=TIME_FLOOR), want)


@pytest.mark.parametrize("b,g", [(1, 12), (17, 352), (3, 1500)])
def test_pareto_mask_kernel_matches_plain(cuda, b, g):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(b * g)
    t = rng.uniform(1e-3, 2.0, (b, g)).astype(np.float32)
    e = rng.uniform(1.0, 500.0, (b, g)).astype(np.float32)
    mask = rng.random((b, g)) < 0.8
    t[:, 5::7] = t[:, 4::7][:, : t[:, 5::7].shape[1]]
    e[:, 5::7] = e[:, 4::7][:, : e[:, 5::7].shape[1]]
    t[0, 2], e[-1, 3] = np.inf, -np.inf
    args = [torch.from_numpy(a).to(cuda) for a in (t, e, mask)]
    got = ops.pareto_mask(*args)
    want = ops.pareto_mask(*args, impl="ref")
    assert torch.equal(got, want)


@pytest.mark.parametrize("g", [1, 128, 129, 352, 513, 1024, 1025, 2000])
def test_pareto_mask_kernel_edge_cases(cuda, g):
    """Both paths (the sort up to 1,024 points a row, all pairs past it)
    against the plain version: -0.0 and +0.0 ties in t and in e, exact (t,
    e) ties, NaN and +-inf, all-infeasible rows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.plan_grid import pareto_plan

    b = 37
    rng = np.random.default_rng(g)
    t = np.round(rng.uniform(-2.0, 2.0, (b, g)), 1).astype(np.float32)  # many t ties
    e = np.round(rng.uniform(-3.0, 3.0, (b, g)), 1).astype(np.float32)
    mask = rng.random((b, g)) < 0.9
    t[rng.random((b, g)) < 0.1] = -0.0  # both zeros, in t and in e
    t[rng.random((b, g)) < 0.1] = 0.0
    e[rng.random((b, g)) < 0.1] = -0.0
    e[rng.random((b, g)) < 0.1] = 0.0
    if g > 1:
        t[:, 1], e[:, 1] = t[:, 0], e[:, 0]  # exact (t, e) ties
        t[1, :2], e[1, :2] = (-0.0, 0.0), (1.0, 1.0)  # the same point once more
        t[2, :2], e[2, :2] = (0.0, -0.0), (0.5, 0.25)
    for bad, frac in ((np.nan, 0.03), (np.inf, 0.03), (-np.inf, 0.03)):
        t[rng.random((b, g)) < frac] = bad
        e[rng.random((b, g)) < frac] = bad
    mask[3] = False  # an all-masked row
    t[4] = np.nan  # an all-NaN feasible row
    e[5, :] = np.inf
    args = [torch.from_numpy(a).to(cuda) for a in (t, e, mask)]
    before = ops.LAUNCHES["pareto_mask"]
    got = ops.pareto_mask(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pareto_mask"] == before + 1
    want = ops.pareto_mask(*args, impl="ref")
    assert torch.equal(got, want)
    assert not got[3:6].any() and bool(want.any())
    assert pareto_plan(b, g).path == ("sort" if g <= 1024 else "pairs")


def test_engine_fused_kernel_path_matches_exact(cuda):
    from repro_torch.core import engine, power
    from repro_torch.core.node_sim import Node
    from repro_torch.fleet.cluster import family_key

    pm = power.fit_power_model(*Node(seed=7).stress_grid())
    eng = engine.PlanningEngine(pm, space=engine.cpu_space(), noise=0.01, seed=0,
                                device=cuda)
    ws = [engine.Workload(arch=a, terms=family_key(a, n), objective=o,
                          constraints=c)
          for a in ("blackscholes", "raytrace") for n in (1.0, 4.0)
          for o in ("energy", "ed2p")
          for c in (None, engine.Constraints(max_cores=16),
                    engine.Constraints(max_time_s=1e-3))]
    assert eng.plan_many(ws) == eng.plan_many(ws, fused=False)
    assert eng.pareto_many(ws) == eng.pareto_many(ws, fused=False)


# the fleet's shapes: a round plans B <= 32 pending jobs on the quick grid
# (G = 96) or the paper's (G = 352); its SVR fits and refits are a few dozen
# to a few hundred telemetry samples
@pytest.mark.parametrize("g", [96, 352])
@pytest.mark.parametrize("b", [1, 7, 32])
def test_planning_kernels_at_fleet_shapes(cuda, b, g):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7 * b + g)
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    w = rng.uniform(50.0, 600.0, (1, g)).astype(np.float32)
    e = t * w
    k = rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)
    mask = rng.random((b, g)) < 0.6
    t[:, 1::4] = t[:, 0::4][:, : t[:, 1::4].shape[1]]  # exact ties
    mask[:, 3::5] = True
    tt, ww, ee, kk, mm = (torch.from_numpy(a).to(cuda) for a in (t, w, e, k, mask))
    before = dict(ops.LAUNCHES)
    got = ops.plan_argmin(tt, ww, kk, mm, time_floor=TIME_FLOOR)
    keep = ops.pareto_mask(tt, ee, mm)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["plan_argmin"] == before["plan_argmin"] + 1
    assert ops.LAUNCHES["pareto_mask"] == before["pareto_mask"] + 1
    assert torch.equal(got, ops.plan_argmin(tt, ww, kk, mm, time_floor=TIME_FLOOR, impl="ref"))
    assert torch.equal(keep, ops.pareto_mask(tt, ee, mm, impl="ref"))


@pytest.mark.parametrize("m", [5, 13, 37])
@pytest.mark.parametrize("n", [5, 13, 37])
def test_rbf_gram_kernel_at_fleet_shapes(cuda, n, m):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(n * 100 + m)
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["rbf_gram"]
    got = ops.rbf_gram(x, y, 0.5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rbf_gram"] == before + 1
    torch.testing.assert_close(got, ops.rbf_gram(x, y, 0.5, impl="ref"), rtol=0, atol=2e-6)


def test_fleet_engine_plans_a_round_of_32_jobs_on_the_card(cuda):
    from repro_torch.core.engine import Constraints, Workload
    from repro_torch.fleet.__main__ import build_jobs
    from repro_torch.fleet.cluster import family_key, make_pool
    from repro_torch.fleet.scheduler import fleet_engine
    from repro_torch.kernels import ops

    pool = make_pool(4, seed=0)
    eng = fleet_engine(pool, noise=0.01, seed=0)
    assert eng.device.type == "cuda"
    ws = [Workload(arch=j.app, terms=family_key(j.app, j.input_size),
                   constraints=Constraints(max_cores=24 if j.job_id % 2 else 32,
                                           max_time_s=j.deadline_s - j.arrival_s))
          for j in build_jobs(32, seed=0)]
    before = dict(ops.LAUNCHES)
    plans = eng.plan_many(ws)
    frontiers = eng.pareto_many(ws)
    assert ops.LAUNCHES["plan_argmin"] == before["plan_argmin"] + 1
    assert ops.LAUNCHES["pareto_mask"] == before["pareto_mask"] + 1
    assert ops.LAUNCHES["rbf_gram"] > before["rbf_gram"]
    launched = dict(ops.LAUNCHES)
    assert plans == eng.plan_many(ws, impl="ref")
    assert frontiers == eng.pareto_many(ws, impl="ref")
    assert dict(ops.LAUNCHES) == launched  # the plain arms launch nothing


def test_fit_many_is_batch_composition_independent_on_the_card(cuda):
    """The service's recovery refit re-fits a journaled set in another
    batch than the live refit did: the models must agree bit for bit."""
    from repro_torch.core import svr
    from repro_torch.core.engine import ENGINE_FIT_KW

    rng = np.random.default_rng(0)
    sets = []
    for i in range(3):
        x = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (12, 2)), np.float32)
        y = np.asarray(10.0 / x[:, 0] + 50.0 / x[:, 1] + i, np.float32)
        sets.append((x, y))
    grid = np.asarray(rng.uniform([1.0, 1], [3.5, 32], (40, 2)), np.float32)
    batched = svr.fit_many(sets, method="auto", device=cuda, **ENGINE_FIT_KW)
    for i in range(3):
        alone = svr.fit_many([sets[i]], method="auto", device=cuda, **ENGINE_FIT_KW)
        assert torch.equal(svr.predict_each(alone, [grid])[0],
                           svr.predict_each([batched[i]], [grid])[0])


def test_quick_service_kill_and_resume_on_the_card(cuda, tmp_path):
    """The ``--quick`` service killed mid-run resumes from its journal to
    the uninterrupted run's schedule, bit for bit, in as many batches."""
    from repro_torch.fleet import __main__ as fleet_main
    from repro_torch.fleet.service import SchedulerService, ServiceKilled

    cfg = dict(quick=True, nodes=4, seed=0, fallback=False, horizon_s=0.0,
               migration_cost_j=2000.0)
    jobs = fleet_main.build_jobs(12, seed=0, input_sizes=(1.0, 2.0))
    drift = [(jobs[len(jobs) // 3].arrival_s + 1.0, fleet_main.DRIFT_APP,
              fleet_main.DRIFT_FACTOR)]

    def rows(sched):
        return [(c.placement.job.job_id, c.placement.node, c.placement.frequency_ghz,
                 c.placement.cores, c.placement.start_s, c.finish_s, c.total_energy_j)
                for c in sched.completed]

    whole = SchedulerService(fleet_main._build_scheduler_from_config(cfg),
                             journal=str(tmp_path / "whole.json"))
    whole.run(jobs, drift_events=drift)
    assert whole.scheduler.engine.device.type == "cuda"
    path = str(tmp_path / "killed.json")
    killed = SchedulerService(fleet_main._build_scheduler_from_config(cfg), journal=path,
                              kill_after_batches=whole.n_batches // 2)
    with pytest.raises(ServiceKilled):
        killed.run(jobs, drift_events=drift)
    resumed = SchedulerService.resume(path, fleet_main._build_scheduler_from_config(cfg))
    resumed.drain()
    assert rows(resumed.scheduler) == rows(whole.scheduler)
    assert len(rows(whole.scheduler)) == 12
    assert resumed.n_batches == whole.n_batches


# ---------------------------------------------------------------------------
# flash attention and the SSD chunk block (the serving path's kernels)
# ---------------------------------------------------------------------------

# (b, h, hk, sq, skv, d, causal, window, q_offset, kv_len)
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, True, None, 0, None),  # MHA
    (2, 4, 2, 67, 67, 32, True, None, 0, None),  # GQA, ragged
    (1, 8, 1, 128, 128, 64, True, None, 0, None),  # MQA
    (2, 4, 2, 80, 80, 32, True, 16, 0, None),  # sliding window
    (2, 4, 4, 48, 48, 32, False, None, 0, None),  # bidirectional
    (2, 6, 2, 130, 130, 128, True, None, 0, None),  # d 128, three q tiles
    (1, 3, 1, 20, 20, 16, True, None, 0, None),  # d 16
    (2, 4, 2, 1, 40, 16, False, None, 25, 26),  # decode step, kv_len < skv
    (2, 24, 2, 1, 1064, 128, False, None, 1055, 1056),  # starcoder2's decode
    (2, 4, 2, 1, 16, 32, False, None, 0, 9),  # decode on a ring cache
    (1, 4, 2, 5, 40, 64, True, None, 30, 35),  # five rows, the row kernel
    (1, 4, 2, 20, 40, 64, True, 8, 30, 25),  # rows 2.. fully masked (tile kernel)
    (1, 4, 2, 4, 40, 64, True, 8, 30, 25),  # the same on the row kernel
    (1, 2, 1, 3, 8, 32, False, None, 0, 0),  # kv_len 0: every row masked
    # the bf16 kernels' edges: sq and skv off the 64-row and 64-key tiles
    (1, 4, 2, 93, 150, 128, False, None, 0, None),
    (2, 4, 2, 70, 131, 64, True, None, 61, None),  # causal, queries at 61..130
    (1, 4, 2, 200, 200, 64, True, 40, 0, None),  # the window's edge inside key tiles
    # decode, packed rows of a kv group: groups 1, 4 and 12
    (2, 2, 2, 1, 300, 64, False, None, 299, 300),
    (2, 8, 2, 1, 200, 128, False, None, 150, 151),
    (2, 12, 2, 4, 90, 32, True, None, 86, 90),  # 24 packed rows: a 32-row block
    (1, 24, 2, 3, 500, 128, True, None, 400, 403),  # 36 packed rows: a 64-row block
    (1, 24, 2, 8, 130, 64, True, 50, 100, 108),  # 96 packed rows: two row blocks
    (1, 4, 2, 1, 1024, 128, False, 100, 1000, 1001),  # more splits than visible key tiles
    # head dim 256 at gemma3-12b's 16 heads over 8 kv heads: causal, and its
    # 1,024-key window with queries at 1020..1099; a decode step past the
    # window; five rows (the row kernel in f32, decode in bf16)
    (1, 16, 8, 200, 200, 256, True, None, 0, None),
    (1, 16, 8, 80, 1100, 256, True, 1024, 1020, None),
    (1, 16, 8, 1, 1300, 256, True, 1024, 1299, 1300),
    (2, 4, 2, 5, 40, 256, True, None, 30, 35),
    (1, 16, 1, 4, 130, 256, True, None, 100, 110),  # 64 packed rows: two 32-row blocks
    # the rest of the zoo: whisper-medium's encoder (1,500 frames,
    # bidirectional, off the 64-row tiles) and cross-attention (64 rows over
    # 1,500 keys) at batch 1; decode steps at zamba2-7b's head dim 112 and
    # phi-3-vision-4.2b's 96 (both padded to 128) over their caches
    (1, 16, 16, 1500, 1500, 64, False, None, 0, None),
    (1, 16, 16, 64, 1500, 64, False, None, 0, None),
    (2, 32, 32, 1, 1064, 112, False, None, 1054, 1055),
    (2, 32, 32, 1, 1640, 96, False, None, 1630, 1631),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, h, hk, sq, skv, d, causal, window, q_offset, kv_len = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sq * 1000 + skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dt)
               for s in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dt and got.shape == want.shape
    # f32: the same function summed in another order; bf16: one rounding
    # of the output to bf16 (2^-7 relative at |out| ~ 1), and per element
    # at most one bf16 ulp (2^-7 of |want|) plus 1e-4 near 0, so that small
    # outputs (a decode row's ~0.05) are held to their own scale
    tol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    if dt == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-4)
    if kv_len == 0:
        assert not got.any()
    if window == 8:  # q_pos - 7 >= kv_len: no key left
        assert not got[:, :, 2:].any()

    # lse, the backward's residual: -inf exactly where the plain version's
    # is; elsewhere f32 sums of the same products in another order (the
    # tensor cores' f32 accumulation on the bf16 paths) and exp2 / log2 with
    # the scale folded in: about 1e-6 of |lse|, held to 1e-5 |lse| + 1e-4
    out2, lse = flash_attention_cuda(q, k, v, scale=None, return_lse=True, **kw)
    _, lse_want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out2, got)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    masked = torch.isneginf(lse_want)
    assert torch.equal(torch.isneginf(lse), masked)
    assert bool(torch.isfinite(lse[~masked]).all())
    torch.testing.assert_close(lse[~masked], lse_want[~masked], rtol=1e-5, atol=1e-4)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import ops

    q = torch.zeros((1, 2, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q, q, q, kv_len=5)


def _flash_against_plain(q, k, v, launches, **kw):
    """The kernel's output and lse against the plain version's, at the
    tolerances of test_flash_attention_kernel_matches_plain; ``launches``
    is the launches the call must make."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    before = ops.LAUNCHES["flash_attention"]
    got, lse = flash_attention_cuda(q, k, v, scale=None, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] - before == launches
    want, lse_want = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert got.dtype == q.dtype and got.shape == want.shape and got.is_contiguous()
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-4)
    masked = torch.isneginf(lse_want)
    assert torch.equal(torch.isneginf(lse), masked)
    torch.testing.assert_close(lse[~masked], lse_want[~masked], rtol=1e-5, atol=1e-4)


# (sq, skv, q_offset, kv_len, causal, dtype): bf16 prefill (the wgmma tiles),
# bf16 decode (packed mma.sync rows, key splits), f32 (the FMA kernels)
FLASH_PATHS = {
    "bf16_prefill": (70, 70, 0, None, True, torch.bfloat16),
    "bf16_decode": (1, 90, 80, 81, False, torch.bfloat16),
    "f32": (20, 40, 20, None, True, torch.float32),
}


@pytest.mark.parametrize("path", sorted(FLASH_PATHS))
@pytest.mark.parametrize("d", [96, 112])
def test_flash_attention_kernel_pads_head_dims_96_and_112(cuda, d, path):
    """Zero-padded to 128 in the wrapper, with the scale of the true d."""
    sq, skv, q_offset, kv_len, causal, dt = FLASH_PATHS[path]
    rng = np.random.default_rng(d + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dt)
               for s in ((2, 6, sq, d), (2, 2, skv, d), (2, 2, skv, d)))
    _flash_against_plain(q, k, v, 1, causal=causal, window=None, q_offset=q_offset,
                         kv_len=kv_len)


@pytest.mark.parametrize("sq, q_offset, kv_len", [(4096, 0, None), (1, 4095, 4096)])
def test_flash_attention_kernel_at_zamba2s_head_dim_224(cuda, sq, q_offset, kv_len):
    """Zamba2-7B's shared blocks: 32 heads of 224 over 4,096 keys, causal,
    bf16, softmax scale (224 / 2)^-1/2, zero-padded to the d 256 instance:
    the prefill and a decode step against ``scaled_dot_product_attention``
    in f32 on the same bf16 values, at the bf16 tolerances above."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(224 + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda,
                                                                              torch.bfloat16)
               for s in ((1, 32, sq, 224), (1, 32, 4096, 224), (1, 32, 4096, 224)))
    scale = 112**-0.5
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=sq > 1, scale=scale, q_offset=q_offset,
                              kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = torch.nn.functional.scaled_dot_product_attention(
        q.float(), k.float(), v.float(), is_causal=sq > 1, scale=scale)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7, atol=1e-4)


@pytest.mark.parametrize("path", sorted(FLASH_PATHS))
def test_flash_attention_kernel_takes_65536_batch_heads(cuda, path):
    """b*h = 65,536 at tiny widths: two launches of whole batch rows, each
    under the f32 grid's y and the decode grid's z."""
    sq, skv, q_offset, kv_len, causal, dt = FLASH_PATHS[path]
    sq, skv = min(sq, 16), min(skv, 24)
    q_offset = 0 if sq > 1 else skv - 1
    kv_len = None if sq > 1 else skv
    b, h, hk, d = 16384, 4, 2, 16
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dt)
               for s in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d)))
    _flash_against_plain(q, k, v, 2, causal=causal, window=None, q_offset=q_offset,
                         kv_len=kv_len)


def _ssd_inputs(rng, b, s, h, p, g, n, device):
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return (t(rng.normal(size=(b, s, h, p))), t(rng.uniform(0.01, 0.2, size=(b, s, h))),
            t(-rng.uniform(0.5, 2.0, size=(h,))), t(rng.normal(size=(b, s, g, n))),
            t(rng.normal(size=(b, s, g, n))))


# (b, h, g, nc, T, p, n)
SSD_CASES = [(2, 4, 1, 3, 16, 8, 16), (2, 4, 2, 2, 32, 8, 16), (1, 4, 1, 1, 40, 32, 16),
             (1, 4, 2, 2, 67, 6, 10), (2, 24, 1, 2, 128, 64, 128),
             (1, 24, 2, 2, 128, 64, 128),  # full width, two groups
             (2, 6, 1, 2, 48, 16, 32),  # 6 heads a group
             (1, 112, 2, 2, 128, 64, 64)]  # zamba2-7b: 56 heads a group, state 64


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunks_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import ops

    b, h, g, nc, T, p, n = case
    rng = np.random.default_rng(T * 100 + p + n)
    x, dt, A, B, C = _ssd_inputs(rng, b, nc * T, h, p, g, n, cuda)
    xc = x.movedim(2, 1).reshape(b * h, nc, T, p).contiguous()
    dtc = dt.movedim(2, 1).reshape(b * h, nc, T).contiguous()
    a = (dtc * A.repeat(b)[:, None, None]).contiguous()
    before = ops.LAUNCHES["ssd_chunks"]
    got = ops.ssd_chunks(xc, dtc, a, B, C, heads=h)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunks"] == before + 1
    want = ops.ssd_chunks(xc, dtc, a, B, C, heads=h, impl="ref")
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        # f32 sums of up to T*n terms in another order, and a cumsum taken
        # as a scan: 1e-4 of the output's scale
        scale = float(wt.abs().max())
        torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-4 * scale)


# (b, h, g, nc): 4 x 16 x 1 = 64 blocks a head slice; 24 heads a group take
# slices of 12 on the H100's 132 SMs, 21 heads one of 11 and one of 10;
# 2 x 2 x 2 = 8 blocks with 6 heads a group, one head a block
SLICE_CASES = [(4, 24, 1, 16), (4, 21, 1, 16), (2, 12, 2, 2)]


@pytest.mark.parametrize("case", SLICE_CASES)
def test_ssd_chunks_kernel_head_slices(cuda, case):
    """A block runs a slice of one group's heads, sharing C B^T; the slice
    ``head_slice`` picks, a last slice shorter than the others included,
    against the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import _sm_count, head_slice

    b, h, g, nc = case
    T, p, n = 32, 16, 32
    per_group = h // g
    heads = head_slice(b * nc * g, per_group, _sm_count(torch.cuda.current_device()))
    rng = np.random.default_rng(h)
    x, dt, A, B, C = _ssd_inputs(rng, b, nc * T, h, p, g, n, cuda)
    xc = x.movedim(2, 1).reshape(b * h, nc, T, p).contiguous()
    dtc = dt.movedim(2, 1).reshape(b * h, nc, T).contiguous()
    a = (dtc * A.repeat(b)[:, None, None]).contiguous()
    got = ops.ssd_chunks(xc, dtc, a, B, C, heads=h)
    torch.cuda.synchronize()
    want = ops.ssd_chunks(xc, dtc, a, B, C, heads=h, impl="ref")
    for gt, wt in zip(got, want):
        scale = float(wt.abs().max())
        torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-4 * scale)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert heads == {24: 12, 21: 11, 12: 1}[h]


def test_ssd_chunks_kernel_takes_65536_batch_heads(cuda):
    """b*h = 65,536 at tiny widths, one launch (a 1-D grid of b*h*nc
    blocks)."""
    from repro_torch.kernels import ops

    b, h, g, T, p, n = 16384, 4, 2, 16, 8, 16
    rng = np.random.default_rng(65536)
    x, dt, A, B, C = _ssd_inputs(rng, b, T, h, p, g, n, cuda)
    xc = x.movedim(2, 1).reshape(b * h, 1, T, p).contiguous()
    dtc = dt.movedim(2, 1).reshape(b * h, 1, T).contiguous()
    a = (dtc * A.repeat(b)[:, None, None]).contiguous()
    before = ops.LAUNCHES["ssd_chunks"]
    got = ops.ssd_chunks(xc, dtc, a, B, C, heads=h)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_chunks"] == before + 1
    want = ops.ssd_chunks(xc, dtc, a, B, C, heads=h, impl="ref")
    for gt, wt in zip(got, want):
        scale = float(wt.abs().max())
        torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("s,chunk,g", [(100, 32, 1), (64, 16, 2)])
def test_ssd_scan_on_the_card_takes_h0(cuda, s, chunk, g):
    """The kernel path from an initial state against the plain path."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(s + chunk + 1)
    x, dt, A, B, C = _ssd_inputs(rng, 2, s, 4, 8, g, 16, cuda)
    h0 = torch.from_numpy(rng.normal(size=(2, 4, 16, 8)).astype(np.float32)).to(cuda)
    before = ops.LAUNCHES["ssd_chunks"]
    y, hs = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0, return_state=True)
    assert ops.LAUNCHES["ssd_chunks"] == before + 1
    y_ref, hs_ref = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0, return_state=True,
                                 impl="ref")
    y0 = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert not torch.allclose(y, y0)  # the state reached the output
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4 * float(y_ref.abs().max()))
    torch.testing.assert_close(hs, hs_ref, rtol=1e-4, atol=1e-4 * float(hs_ref.abs().max()))


@pytest.mark.parametrize("s,chunk,g", [(100, 32, 1), (64, 16, 2), (40, 40, 1)])
def test_ssd_scan_on_the_card_matches_plain(cuda, s, chunk, g):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(s + chunk)
    x, dt, A, B, C = _ssd_inputs(rng, 2, s, 4, 8, g, 16, cuda)
    before = ops.LAUNCHES["ssd_chunks"]
    y, hs = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, return_state=True)
    assert ops.LAUNCHES["ssd_chunks"] == before + 1
    y_ref, hs_ref = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, return_state=True, impl="ref")
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4 * float(y_ref.abs().max()))
    torch.testing.assert_close(hs, hs_ref, rtol=1e-4, atol=1e-4 * float(hs_ref.abs().max()))


@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "mamba2-130m"])
def test_smoke_lm_on_the_card_runs_the_kernels(cuda, arch_id):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    arch, cfg, model = serve.build(arch_id, smoke=True, seed=3, device=cuda)
    prompts = serve.make_prompts(cfg, 2, 37, seed=3)
    name = "ssd_chunks" if arch_id.startswith("mamba") else "flash_attention"
    before = ops.LAUNCHES[name]
    got = serve.run(arch, cfg, model, prompts, 5)
    launches = ops.LAUNCHES[name] - before
    want = serve.run(arch, cfg, model, prompts, 5, impl="ref", forced=got.tokens)
    assert ops.LAUNCHES[name] - before == launches
    per_pass = cfg.n_layers
    assert launches == (per_pass if name == "ssd_chunks" else per_pass * 5)
    torch.testing.assert_close(got.prefill_logits, want.prefill_logits, rtol=0, atol=1e-4)
    for a, b in zip(got.step_logits, want.step_logits):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the int8 codec (the training path's kernels)
# ---------------------------------------------------------------------------


def _codec_edges():
    """Zero, NaN, +inf, -inf and half-way blocks, then a ragged tail."""
    rng = np.random.default_rng(5)
    blocks = [np.zeros(256, np.float32)]
    for bad in (np.nan, np.inf, -np.inf):
        b = (rng.standard_normal(256) * 3).astype(np.float32)
        b[rng.integers(256)] = bad
        blocks.append(b)
    b = np.zeros(256, np.float32)
    b[0] = 127.0
    b[1:9] = [0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -126.5, 3.5]
    blocks.append(b)
    blocks.append((rng.standard_normal(77) * 1e-3).astype(np.float32))
    return np.concatenate(blocks)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 70001, 1000003, -1])
def test_int8_codec_kernels_match_plain_bit_for_bit(cuda, n):
    from repro_torch.kernels import ops

    x_np = _codec_edges() if n < 0 else (
        np.random.default_rng(n).standard_normal(n) * 2.0).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda)
    before = dict(ops.LAUNCHES)
    q, s = ops.int8_quantize(x)
    x_back = ops.int8_dequantize(q, s, n=x.numel())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["int8_quantize"] == before["int8_quantize"] + 1
    assert ops.LAUNCHES["int8_dequantize"] == before["int8_dequantize"] + 1
    q_ref, s_ref = ops.int8_quantize(x, impl="ref")
    assert torch.equal(q, q_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    back_ref = ops.int8_dequantize(q_ref, s_ref, n=x.numel(), impl="ref")
    assert torch.equal(x_back.view(torch.int32), back_ref.view(torch.int32))
    assert x_back.shape == x.shape and q.numel() == s.numel() * 256


def test_int8_codec_kernels_take_unaligned_views(cuda):
    from repro_torch.kernels import ops

    x = torch.randn(5000, device=cuda)[3:]  # 12 bytes past an aligned start
    q, s = ops.int8_quantize(x)
    q_ref, s_ref = ops.int8_quantize(x, impl="ref")
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    qv = q[4:]  # an int8 view 4 bytes in, of 7 whole blocks
    back = ops.int8_dequantize(qv[: 7 * 256], s[1:8], n=1700)
    assert torch.equal(back, ops.int8_dequantize(qv[: 7 * 256], s[1:8], n=1700, impl="ref"))


# ---------------------------------------------------------------------------
# gradients through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_under_autograd(cuda, dtype, d):
    """Kernel arm against plain arm. bf16 at d 32: the forward saves (out,
    lse) and the backward is the Hopper kernel (one launch of each); f32
    and d 256: the backward recomputes (out, lse) with the forward kernel
    (a second launch) and runs the plain chunked backward. f32: out within
    2e-5 and lse within ~1e-6 move each gradient by well under 1e-3 of its
    scale; bf16: out differs by one bf16 ulp (2^-8 relative), the kernel
    rounds P and dS to bf16 as operands (2^-9 relative each) and every
    gradient is rounded to bf16 once, so a few ulps, 2^-6 of its scale."""
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    kernel_bwd = dt == torch.bfloat16 and d != 256
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dt)
               for s in ((2, 6, 67, d), (2, 2, 67, d), (2, 2, 67, d)))
    w = torch.from_numpy(rng.standard_normal((2, 6, 67, d)).astype(np.float32)).to(cuda)
    grads = {}
    for impl in (None, "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(ops.LAUNCHES)
        out = ops.flash_attention(*leaves, causal=True, window=24, impl=impl)
        assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == (
            1 if impl is None else 0)
        assert out.grad_fn is not None
        (out.float() * w).sum().backward()
        fwd = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
        bwd = ops.LAUNCHES["attention_bwd"] - before["attention_bwd"]
        if impl is None:
            assert (fwd, bwd) == ((1, 1) if kernel_bwd else (2, 0))
        else:
            assert (fwd, bwd) == (0, 0)
        grads[impl] = [t.grad for t in leaves]
    rtol = 1e-3 if dt == torch.float32 else 2.0 ** -6
    for a, b in zip(grads[None], grads["ref"]):
        assert a is not None and a.dtype == dt and bool(torch.isfinite(a).all())
        scale = float(b.float().abs().max())
        atol = (1e-4 if dt == torch.float32 else 2.0 ** -6) * scale
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


# the Hopper attention backward's cases: (b, h, hk, sq, skv, d, causal,
# window, q_offset, kv_len). Head dims 16, 32, 64, 128 and the padded 96 and
# 112; groups 1, 3 and 12 and MQA; causal and bidirectional, a window, query
# offsets and kv_len below skv; lengths off the 64-row and 128-key tiles
# (67, 93, 1,000); rows that see no key; and starcoder2-3b's training shape
ATTN_BWD_CASES = [
    (1, 4, 4, 67, 67, 16, True, None, 0, None),
    (2, 6, 2, 67, 67, 64, True, None, 0, None),
    (1, 3, 1, 1000, 1000, 32, True, None, 0, None),
    (1, 24, 2, 1000, 1000, 128, True, None, 0, None),
    (1, 4, 2, 93, 150, 128, False, None, 0, None),
    (2, 4, 2, 70, 131, 64, True, None, 61, None),
    (1, 4, 2, 200, 200, 64, True, 40, 0, None),
    (1, 12, 1, 130, 130, 64, True, None, 0, 100),
    (1, 2, 1, 64, 300, 32, False, 50, 236, 280),
    (1, 4, 2, 20, 40, 16, True, 8, 30, 25),
    (1, 2, 2, 20, 40, 64, False, None, 0, 0),
    (1, 6, 2, 67, 67, 96, True, None, 0, None),
    (1, 6, 2, 90, 90, 112, False, 30, 0, None),
    (2, 24, 2, 4096, 4096, 128, True, None, 0, None),
]


@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_attention_bwd_kernel_matches_plain(cuda, case):
    """dq, dk, dv of the kernel (bf16) against the plain backward in f32 on
    the same bf16 inputs and the same (out, lse). The kernel rounds P and
    dS to bf16 as the operands of its products (2^-9 relative each; the
    sums over a row's keys or queries keep f32) and its outputs to bf16 once
    (2^-9 relative): its worst element lies within 1e-2 of the gradient's
    largest, and its error over all elements within 2^-8 of the gradient's
    norm; the plain backward run in bf16 itself is held to the same."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.attention_bwd import attention_bwd_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, h, hk, sq, skv, d, causal, window, q_offset, kv_len = case
    rng = np.random.default_rng(sq * 1000 + skv + d)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        cuda, torch.bfloat16) for s in ((b, h, sq, d), (b, hk, skv, d), (b, hk, skv, d),
                                        (b, h, sq, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    out, lse = flash_attention_cuda(q, k, v, scale=None, return_lse=True, **kw)
    before = ops.LAUNCHES["attention_bwd"]
    got = attention_bwd_cuda(q, k, v, out, lse, dout, scale=None, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["attention_bwd"] == before + 1
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), **kw)
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for g, w, pl, like in zip(got, want, plain, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == like.shape and g.is_contiguous()
        assert bool(torch.isfinite(g).all())
        if kv_len == 0:
            assert not g.any()
            continue
        scale = float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=0, atol=1e-2 * scale)
        norm = float(w.norm())
        assert float((g.float() - w).norm()) <= 2.0 ** -8 * norm
        assert float((pl.float() - w).norm()) <= 2.0 ** -8 * norm


@pytest.mark.parametrize("dtype,d,kernel", [("bfloat16", 64, True), ("bfloat16", 112, True),
                                            ("float32", 64, False), ("bfloat16", 256, False)])
def test_attention_backward_takes_the_kernel_by_dtype_and_head_dim(cuda, dtype, d, kernel):
    """bf16 at head dims up to 128 (112 padded) runs the Hopper backward; f32
    (the caller's precision) and d 256 (tiles of their own) run the plain
    one, after recomputing (out, lse) with the forward kernel."""
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dt).requires_grad_(True)
               for s in ((1, 4, 80, d), (1, 2, 80, d), (1, 2, 80, d)))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True)
    assert len(out.grad_fn.saved_tensors) == (5 if kernel else 3)
    out.float().sum().backward()
    torch.cuda.synchronize()
    launched = {n: ops.LAUNCHES[n] - before[n] for n in ("flash_attention", "attention_bwd")}
    assert launched == ({"flash_attention": 1, "attention_bwd": 1} if kernel
                        else {"flash_attention": 2, "attention_bwd": 0})
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


def test_ssd_scan_kernel_under_autograd(cuda):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(1)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 100, 4, 8, 1, 16, cuda)
    w = torch.randn(2, 100, 4, 8, device=cuda)
    grads = {}
    for impl in (None, "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        before = ops.LAUNCHES["ssd_chunks"]
        y = ops.ssd_scan(*leaves, chunk=32, impl=impl)
        assert ops.LAUNCHES["ssd_chunks"] - before == (1 if impl is None else 0)
        (y * w).sum().backward()
        grads[impl] = [t.grad for t in leaves]
    for a, b in zip(grads[None], grads["ref"]):
        assert a is not None and torch.equal(a, b)


@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "mamba2-130m"])
def test_smoke_lm_training_on_the_card_gives_every_parameter_a_gradient(cuda, arch_id):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    arch = get_arch(arch_id)
    cfg = arch.smoke
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                                     generator=torch.Generator(cuda).manual_seed(0))}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    name = "ssd_chunks" if arch_id.startswith("mamba") else "flash_attention"
    out = {}
    for impl in (None, "ref"):
        model = arch.init(torch.Generator(cuda).manual_seed(4), cfg, device=cuda)
        params = steps.trainable(model)
        before = ops.LAUNCHES[name]
        loss, _, grads = steps.loss_and_grads(arch, cfg, model, batch, impl=impl)
        launched = ops.LAUNCHES[name] - before
        # forward, the per-layer recomputation in the backward, and the
        # attention backward's recompute of (out, lse) (SSD: the first two)
        per_layer = 2 if name == "ssd_chunks" else 3
        assert launched == (per_layer * cfg.n_layers if impl is None else 0)
        assert set(grads) == set(params)
        assert all(bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
                   for g in grads.values())
        out[impl] = (loss, grads)
    torch.testing.assert_close(out[None][0], out["ref"][0], rtol=0, atol=1e-5)
    for k in out[None][1]:
        g, r = out[None][1][k], out["ref"][1][k]
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4 * float(r.abs().max()))


def test_f32_output_matmul_has_the_gradient_of_its_f32_form(cuda):
    """The bf16 unembedding on the card (``torch.mm(..., out_dtype=f32)``,
    which has no derivative of its own) against autograd through the same
    product in f32: the output gradient is rounded to bf16 once and the two
    products round their results to bf16, so 2^-7 of each gradient's scale."""
    from repro_torch.models import common

    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(3, 64, 96, generator=gen, device=cuda).bfloat16().requires_grad_(True)
    table = torch.randn(200, 96, generator=gen, device=cuda).bfloat16().requires_grad_(True)
    w = torch.randn(3, 64, 200, generator=gen, device=cuda)
    y = common._matmul_f32(x, table.t())
    assert y.dtype == torch.float32 and y.grad_fn is not None
    (y * w).sum().backward()
    xf = x.detach().float().requires_grad_(True)
    tf = table.detach().float().requires_grad_(True)
    ((xf @ tf.t()) * w).sum().backward()
    torch.testing.assert_close(y, (xf @ tf.t()).detach(), rtol=0, atol=1e-3)
    for got, want in ((x.grad, xf.grad), (table.grad, tf.grad)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=2.0 ** -7 * float(want.abs().max()))


def _flash_inputs(cuda, requires_grad=False):
    gen = torch.Generator(cuda).manual_seed(0)
    return [torch.randn(1, 2, 128, 64, generator=gen, device=cuda).bfloat16()
            .requires_grad_(requires_grad) for _ in range(3)]


def test_span_holds_its_kernels_launch_on_the_profilers_clock(cuda):
    """Under the benchmark's profiler settings (the device's activity
    alone), a span around one flash-attention call holds that launch's
    runtime call, and ``chipbench/program_trace.py`` gives the span the
    kernel's device time: the recorder and the profiler share a clock."""
    from torch.profiler import profile

    from chipbench import program_trace
    from chipbench import trace as bench_trace
    from repro_torch import obs
    from repro_torch.kernels import ops

    q, k, v = _flash_inputs(cuda)
    ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    with obs.recording() as rec:
        with profile(activities=bench_trace.activities("cuda")) as prof:
            with obs.span("probe", cat="test"):
                ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
    payload = obs.export_run(rec)
    program = {"events": payload["traceEvents"], "epoch_ns": payload["meta"]["epoch_ns"]}
    (span,) = program_trace.recorded_spans(program)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and "flash" in e.name()]
    assert len(kernels) == 1
    (launch,) = [e for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CPU
                 and e.correlation_id() == kernels[0].correlation_id()]
    assert span.start_ns <= launch.start_ns() <= span.end_ns
    got = program_trace.reduce(prof, program)["spans"]["probe"]
    assert got["n"] == 1
    assert got["device_ms"] == pytest.approx(kernels[0].duration_ns() / 1e6, rel=1e-9)


def test_backward_span_on_the_autograd_thread_takes_the_waiting_span(cuda):
    """On the card autograd runs the backward on its own device thread; the
    ``attention.bwd`` opened there is still a child of the span that
    waits in ``torch.autograd.grad``."""
    import threading

    from repro_torch import obs
    from repro_torch.kernels import ops

    q, k, v = _flash_inputs(cuda, requires_grad=True)
    threads = []
    q.register_hook(lambda g: threads.append(threading.get_ident()))
    with obs.recording() as rec:
        with obs.span("train.loss_and_grads", cat="train", step=3):
            torch.autograd.grad(ops.flash_attention(q, k, v).float().sum(), [q, k, v])
    assert threads and threads[0] != threading.get_ident()
    by_name = {e["name"]: e["args"] for e in rec.trace.events()}
    assert by_name["attention.bwd"]["parent"] == by_name["train.loss_and_grads"]["id"]
    assert by_name["attention.bwd"]["step"] == 3
