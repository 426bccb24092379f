"""Port parity, the MoE block: ``repro_torch.models.moe`` against the JAX
package's ``repro.models.moe`` in float32 on the CPU.

The reference's weights are carried across and both packages run the same
inputs, made from a numpy seed. The dispatch (which choices are kept,
which dropped past the capacity, and each kept choice's expert slot) is
held to the reference's own ``combine`` tensor, read from its combine
einsum: equal support, gates within 1e-6. The output agrees within 1e-5,
both aux losses within 1e-5 absolute or relative (the z-loss averages
squared log-partitions, 2,500 where one expert's logit is 50), and the
gradients within 1e-5: the two packages sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro_torch import convert
from repro_torch.models import moe

CPU = torch.device("cpu")
GEN = torch.Generator(device="cpu")
ATOL = 1e-5

CFG = dict(d_model=16, d_expert=24, n_experts=4, top_k=2)


def _pair(**kw):
    cfg = dict(CFG, **kw)
    return r_moe.MoEConfig(**cfg), moe.MoEConfig(**cfg)


def _setup(router, r_cfg, p_cfg, b, s, seed):
    """Reference weights (the router replaced by ``router(w)`` of its
    numpy copy), the port's module holding them, and x (b, s, d)."""
    params = jax.tree_util.tree_map(np.asarray, r_moe.init(jax.random.PRNGKey(seed), r_cfg,
                                                           jnp.float32))
    params["router"]["w"] = router(np.array(params["router"]["w"])).astype(np.float32)
    mod = moe.init(p_cfg, torch.float32, generator=GEN, device=CPU)
    convert.load_reference_params(mod, convert.flatten_reference(params))
    x = np.random.default_rng(seed).standard_normal((b, s, r_cfg.d_model)).astype(np.float32)
    return params, mod, x


class _Capture:
    """``jnp`` for the reference's module, keeping its combine einsum's
    output."""

    def __init__(self):
        self.combine = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        out = jnp.einsum(spec, *ops, **kw)
        if spec == "bsk,bske,bskc->bsec":
            self.combine = np.asarray(out)
        return out


def _reference(params, r_cfg, x, monkeypatch):
    cap = _Capture()
    monkeypatch.setattr(r_moe, "jnp", cap)
    y, aux = r_moe.forward(jax.tree_util.tree_map(jnp.asarray, params), r_cfg, jnp.asarray(x))
    monkeypatch.undo()
    return np.asarray(y), {k: float(v) for k, v in aux.items()}, cap.combine


def _all_to_expert_0(w):
    # a constant input feature (set in the case) times a large weight
    # makes expert 0 every token's first choice
    w[0, :] = 0.0
    w[0, 0] = 10.0
    return w


def _tie_1_2(w):
    w[:, 2] = w[:, 1]  # experts 1 and 2 tie exactly for every token
    return w


# name: (router transform, b, s, config changes, x feature 0 set to 5)
CASES = {
    "random": (lambda w: w * 50.0, 2, 16, {}, False),
    "drops": (_all_to_expert_0, 2, 16, {}, True),
    "all-tie": (np.zeros_like, 2, 16, {}, False),
    "pair-tie": (lambda w: _tie_1_2(w * 50.0), 2, 12, dict(top_k=3), False),
    "decode": (lambda w: w * 50.0, 3, 1, {}, False),
    "ungated-gelu": (lambda w: w * 50.0, 2, 10, dict(gated=False, act="gelu"), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(case, monkeypatch):
    router, b, s, change, const = CASES[case]
    r_cfg, p_cfg = _pair(**change)
    params, mod, x = _setup(router, r_cfg, p_cfg, b, s, seed=len(case))
    if const:
        x[..., 0] = 5.0
    y_ref, aux_ref, combine_ref = _reference(params, r_cfg, x, monkeypatch)

    xt = torch.from_numpy(x)
    probs = torch.softmax(mod.router(xt), dim=-1)
    combine, _ = moe.combine_weights(p_cfg, probs)
    C = moe.capacity(p_cfg, s)
    assert combine.shape == combine_ref.shape == (b, s, p_cfg.n_experts, C)
    np.testing.assert_array_equal(combine.numpy() > 0, combine_ref > 0)  # kept and slots
    np.testing.assert_allclose(combine.numpy(), combine_ref, rtol=0, atol=1e-6)

    y, aux = moe.forward(mod, p_cfg, xt)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=ATOL)
    for key in ("load_balance_loss", "router_z_loss"):
        assert float(aux[key]) == pytest.approx(aux_ref[key], rel=ATOL, abs=ATOL), key

    kept = int((combine_ref > 0).sum())
    if case in ("drops", "all-tie"):  # more first choices of one expert than C
        assert kept < b * s * p_cfg.top_k
    if case == "decode":
        assert C == 4 and kept == b * p_cfg.top_k


def test_ties_go_to_the_lower_index_as_jax_top_k():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                           [0.4, 0.1, 0.4, 0.1]]])
    vals, idx = moe.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[[0, 1], [1, 2], [0, 2]]]


def test_capacity_matches_reference():
    for s in (1, 7, 16, 1024):
        for kw in ({}, dict(n_experts=32, top_k=8), dict(n_experts=16, top_k=2)):
            r_cfg, p_cfg = _pair(**kw)
            assert moe.capacity(p_cfg, s) == r_moe.capacity(r_cfg, s)
    # granite-moe's full-width prefill and decode
    _, p_cfg = _pair(n_experts=32, top_k=8)
    assert (moe.capacity(p_cfg, 1024), moe.capacity(p_cfg, 1)) == (320, 4)


def test_gradients_match_reference():
    """d(sum(y * g) + lb + z) / d(every weight, x), through the gates, the
    router's softmax and both aux losses."""
    r_cfg, p_cfg = _pair()
    params, mod, x = _setup(lambda w: w * 50.0, r_cfg, p_cfg, 2, 12, seed=3)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def r_loss(p, xx):
        y, aux = r_moe.forward(p, r_cfg, xx)
        return jnp.sum(y * g) + aux["load_balance_loss"] + aux["router_z_loss"]

    r_grads, r_dx = jax.grad(r_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    mod.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.forward(mod, p_cfg, xt)
    loss = (y * torch.from_numpy(g)).sum() + aux["load_balance_loss"] + aux["router_z_loss"]
    loss.backward()
    want = convert.flatten_reference(jax.tree_util.tree_map(np.asarray, r_grads))
    got = dict(mod.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(r_dx), rtol=0, atol=ATOL)


def test_router_is_float32_in_a_bf16_model():
    _, p_cfg = _pair()
    mod = moe.init(p_cfg, torch.bfloat16, generator=GEN, device=CPU)
    assert mod.router.w.dtype == torch.float32
    assert {mod.experts.up.w.dtype, mod.experts.gate.w.dtype,
            mod.experts.down.w.dtype} == {torch.bfloat16}
    assert tuple(mod.experts.up.w.shape) == (4, 16, 24)
    assert tuple(mod.experts.down.w.shape) == (4, 24, 16)
    y, aux = moe.forward(mod, p_cfg, torch.randn(2, 5, 16, generator=GEN).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux["router_z_loss"].dtype == torch.float32
