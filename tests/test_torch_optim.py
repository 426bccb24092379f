"""Port parity, optimizer and gradient compression: ``repro_torch.optim``
against the JAX package on the CPU.

AdamW runs side by side with the reference's jitted ``adamw.update`` on
the same numpy-seeded parameters and gradients. Compression runs on gloo
in 1, 2 and 4 processes (``torch.multiprocessing.spawn``, a ``FileStore``
under the test's temporary directory) against the reference's
``compressed_grad_tree`` / ``compressed_psum`` under
``jax.vmap(axis_name="data")``, which binds the axis as its ``shard_map``
does. Tolerances are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers import torch_compress_worker
from repro.optim import adamw as r_adamw
from repro.optim import compress as r_compress
from repro_torch.optim import adamw, compress

SHAPES = {"a": (37, 21), "b": (256,), "c": (3, 5, 11)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_across_warmup(clip, dtype):
    """Five steps with warm-up 3 (steps 1-2 warm, 3-5 cosine); gradients
    large enough that clipping at 1.0 is active."""
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=6, clip_norm=clip)
    rng = np.random.default_rng(1 + (clip is None))
    p0 = _tree(rng, 0.5)
    grads = [_tree(rng, 0.3) for _ in range(5)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    r_cfg = r_adamw.AdamWConfig(**cfg_kw)
    r_params = {k: jnp.asarray(v, jd) for k, v in p0.items()}
    r_state = r_adamw.init(r_params)
    r_update = jax.jit(lambda p, g, s: r_adamw.update(r_cfg, p, g, s))

    cfg = adamw.AdamWConfig(**cfg_kw)
    # copies: the update works in place, and jnp.asarray may share a numpy
    # buffer that happens to be 64-byte aligned (about 1 in 20 here), so an
    # in-place step on a torch view of p0 would move the reference's
    # parameters too
    params = {k: torch.tensor(v).to(td) for k, v in p0.items()}
    state = adamw.init(params)
    for g in grads:
        r_params, r_state, r_m = r_update(r_params, {k: jnp.asarray(v, jd) for k, v in g.items()},
                                          r_state)
        m = adamw.update(cfg, params, {k: torch.tensor(v).to(td) for k, v in g.items()},
                         state)
        # the schedule's f32 cos and the norm's sum order: a few ulps
        np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
        assert int(state["step"]) == int(r_state["step"])
        for k in SHAPES:
            want_p = np.asarray(r_params[k].astype(jnp.float32))
            # f32: the same expressions, a few ulps of |p| ~ 1 from the moments'
            # order; bf16: one rounding of that to bf16, at most one ulp (2^-8)
            atol = 2e-6 if dtype == "float32" else 2.0 ** -8 * float(np.abs(want_p).max())
            np.testing.assert_allclose(params[k].float().numpy(), want_p, rtol=0, atol=atol)
            # b1 m + (1 - b1) g may cancel: a few ulps of its terms (|g| < 1.5,
            # ulp 1.2e-7), absolute; XLA may fuse the sum into an FMA
            np.testing.assert_allclose(state["m"][k].numpy(), np.asarray(r_state["m"][k]),
                                       rtol=1e-6, atol=5e-8)
            np.testing.assert_allclose(state["v"][k].numpy(), np.asarray(r_state["v"][k]),
                                       rtol=1e-6, atol=5e-8)
        assert params["a"].dtype == td and state["m"]["a"].dtype == torch.float32


def test_adamw_schedule_matches_reference():
    cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20, total_steps=100)
    r_cfg = r_adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=20, total_steps=100)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: r_adamw.schedule(r_cfg, s))(jnp.asarray(steps)))
    got = adamw.schedule(cfg, torch.from_numpy(steps.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_update_is_in_place_and_leaves_the_gradients():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 10.0)}
    state = adamw.init(params)
    w, m = params["w"], state["m"]["w"]
    adamw.update(adamw.AdamWConfig(warmup_steps=1), params, grads, state)
    assert params["w"] is w and state["m"]["w"] is m
    assert not torch.equal(w, torch.ones(4)) and int(state["step"]) == 1
    torch.testing.assert_close(grads["w"], torch.full((4,), 10.0))
    # the moment took the gradient clipped to norm 1: (1 - b1) * 0.5
    torch.testing.assert_close(m, torch.full((4,), 0.1 * 0.5))
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    assert float(norm) == 20.0
    torch.testing.assert_close(clipped["w"], torch.full((4,), 0.5))


# ---------------------------------------------------------------------------
# compression on gloo, against the reference under jax.vmap
# ---------------------------------------------------------------------------


def _compress_inputs(ranks: int, seed: int):
    rng = np.random.default_rng(seed)
    out = {"x": rng.standard_normal((ranks, 1000)).astype(np.float32)}
    for k, s in SHAPES.items():
        out[f"g/{k}"] = rng.standard_normal((ranks,) + s).astype(np.float32)
        out[f"r/{k}"] = (rng.standard_normal((ranks,) + s) * 0.01).astype(np.float32)
    return out


def _reference(inputs):
    def f(g, r, x):
        red, res = r_compress.compressed_grad_tree(g, r, "data")
        return red, res, r_compress.compressed_psum(x, "data")

    g = {k: jnp.asarray(inputs[f"g/{k}"]) for k in SHAPES}
    r = {k: jnp.asarray(inputs[f"r/{k}"]) for k in SHAPES}
    red, res, ps = jax.jit(jax.vmap(f, axis_name="data"))(g, r, jnp.asarray(inputs["x"]))
    return ({k: np.asarray(v) for k, v in red.items()},
            {k: np.asarray(v) for k, v in res.items()}, np.asarray(ps))


def _spawn(ranks: int, inputs, tmp_path, convergence=False):
    np.savez(tmp_path / "inputs.npz", **inputs)
    mp.spawn(torch_compress_worker.run, args=(ranks, str(tmp_path), convergence),
             nprocs=ranks, join=True)
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(ranks)]


def _one_step_of_the_final_gather(want: np.ndarray) -> float:
    """A block's quantization step after the reduction: its largest |value|
    over 127 (the all-gathered chunk is quantized once more)."""
    return float(np.abs(want).max()) / 127.0


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_compressed_grad_tree_and_psum_match_reference_on_gloo(ranks, tmp_path):
    """The port writes the reference's expressions (``flat - deq``, and
    the senders' products rounded, then summed); the reference compiled
    fuses both into multiply-adds with one rounding. So: the residual
    within one ulp of g + r (deq's rounding); bit for bit at 1 rank, where
    one sender leaves no sum; at 2 and 4 ranks the sum may differ in its
    last bit, which moves a block's scale by an ulp and now and then an
    element by one quantization step of the final gather (measured: 924
    of 2,396 elements differ at 2 ranks, each within that step). At 4
    ranks the error-feedback convergence check runs too."""
    inputs = _compress_inputs(ranks, seed=ranks)
    want_g, want_r, want_psum = _reference(inputs)
    outs = _spawn(ranks, inputs, tmp_path, convergence=(ranks == 4))
    for rank, out in enumerate(outs):
        for k in SHAPES:
            g_eff = inputs[f"g/{k}"][rank] + inputs[f"r/{k}"][rank]
            np.testing.assert_array_less(np.abs(out[f"r/{k}"] - want_r[k][rank]),
                                         np.spacing(np.abs(g_eff)) * 1.0001)
            if ranks == 1:
                np.testing.assert_array_equal(out[f"g/{k}"], want_g[k][rank])
            else:
                np.testing.assert_allclose(out[f"g/{k}"], want_g[k][rank], rtol=0,
                                           atol=_one_step_of_the_final_gather(want_g[k]))
        if ranks == 1:
            np.testing.assert_array_equal(out["psum"], want_psum[rank])
        else:
            np.testing.assert_allclose(out["psum"], want_psum[rank], rtol=0,
                                       atol=_one_step_of_the_final_gather(want_psum))
        # every rank holds the same reduced gradient
        for k in SHAPES:
            np.testing.assert_array_equal(out[f"g/{k}"], outs[0][f"g/{k}"])
    if ranks == 4:
        out = outs[0]
        err_plain = float(np.linalg.norm(out["w_plain"] - out["w_true"]))
        err_comp = float(np.linalg.norm(out["w_comp"] - out["w_true"]))
        # the reference's own criterion (tests/helpers/distributed_checks.py)
        assert err_comp < max(2 * err_plain, 0.05), (err_plain, err_comp)


def test_compressed_mean_is_close_to_the_exact_mean(tmp_path):
    """The compressed mean over 2 ranks stays within two quantization steps
    of the exact f32 mean (one for the senders' int8, one for the gather)."""
    inputs = _compress_inputs(2, seed=7)
    outs = _spawn(2, inputs, tmp_path)
    for k in SHAPES:
        exact = (inputs[f"g/{k}"] + inputs[f"r/{k}"]).mean(axis=0)
        step = float(np.abs(inputs[f"g/{k}"] + inputs[f"r/{k}"]).max()) / 127.0
        np.testing.assert_allclose(outs[0][f"g/{k}"], exact, rtol=0, atol=2 * step)


def test_compression_on_one_rank_counts_its_codec_calls(monkeypatch):
    """Per tensor: three quantizations and one dequantization through
    ``ops`` (the other two dequantizations are plain torch, as in the
    reference), which the card counts as kernel launches."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    calls = {"q": 0, "d": 0}
    real_q, real_d = ops.int8_quantize, ops.int8_dequantize

    def q(*a, **k):
        calls["q"] += 1
        return real_q(*a, **k)

    def d(*a, **k):
        calls["d"] += 1
        return real_d(*a, **k)

    monkeypatch.setattr(ops, "int8_quantize", q)
    monkeypatch.setattr(ops, "int8_dequantize", d)
    group = mesh.make_data_group(torch.device("cpu"))
    assert dist.get_backend() == "gloo" and dist.get_world_size(group) == 1
    rng = np.random.default_rng(3)
    grads = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    resid = compress.init_residuals(grads)
    before = {k: v.clone() for k, v in grads.items()}
    compress.compressed_grad_tree(grads, resid, group)
    assert calls == {"q": 3 * len(SHAPES), "d": len(SHAPES)}
    for k in SHAPES:  # in place: the gradient is now Q(g), the residual g - Q(g)
        torch.testing.assert_close(grads[k] + resid[k], before[k], rtol=0, atol=1e-6)
