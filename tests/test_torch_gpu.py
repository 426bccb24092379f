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


def test_rbf_gram_kernel_rejects_wide_features(cuda):
    from repro_torch.kernels import ops

    x = torch.zeros((4, 17), device=cuda)
    with pytest.raises(ValueError, match="feature dim"):
        ops.rbf_gram(x, x, 0.5)


@pytest.mark.parametrize("b,g", [(1, 7), (33, 352), (300, 130)])
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
    got = ops.plan_argmin(*args, time_floor=TIME_FLOOR)
    want = ops.plan_argmin(*args, time_floor=TIME_FLOOR, impl="ref")
    assert torch.equal(got, want)
    assert (got[::5] == 0).all()


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
