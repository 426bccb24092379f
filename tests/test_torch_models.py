"""Port parity, models: ``repro_torch.models`` (common, attention, mamba2,
lm) against the JAX package's ``repro.models`` at small widths, on the CPU.

The reference initialises the weights (``jax.random``); they are carried
across as numpy arrays (``convert.load_reference_params`` /
``lm_params_from_reference``) and both packages run the same inputs, made
from a numpy seed. Everything here is float32 unless a test says bf16, and
the two packages sum in different orders, so values agree within a few
float32 ulps of their scale: tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_12b as r_gemma_cfg
from repro.configs import granite_moe_1b_a400m as r_gmoe_cfg
from repro.configs import mamba2_130m as r_mamba_cfg
from repro.configs import starcoder2_3b as r_star_cfg
from repro.models import attention as r_attention
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.models import mamba2 as r_mamba2
from repro_torch import convert
from repro_torch.configs import gemma3_12b as p_gemma_cfg
from repro_torch.configs import granite_moe_1b_a400m as p_gmoe_cfg
from repro_torch.configs import mamba2_130m as p_mamba_cfg
from repro_torch.configs import starcoder2_3b as p_star_cfg
from repro_torch.models import attention, common, lm, mamba2

CPU = torch.device("cpu")
GEN = torch.Generator(device="cpu")

# the reference's entry points, jitted (its eager dispatch is what costs here)
r_attn_forward = jax.jit(r_attention.forward, static_argnums=(1,),
                         static_argnames=("return_cache", "max_cache_len"))
r_attn_decode = jax.jit(r_attention.decode_step, static_argnums=(1,))
r_mamba_forward = jax.jit(r_mamba2.forward, static_argnums=(1,),
                          static_argnames=("return_state",))
r_mamba_decode = jax.jit(r_mamba2.decode_step, static_argnums=(1,))
r_lm_prefill = jax.jit(r_lm.prefill, static_argnums=(0,), static_argnames=("max_cache_len",))
r_lm_decode = jax.jit(r_lm.decode_step, static_argnums=(0,))
r_lm_forward = jax.jit(r_lm.forward, static_argnums=(0,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, ref_params):
    return convert.load_reference_params(module, convert.flatten_reference(_np(ref_params)))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, atol, rtol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_reference(bias):
    rp = r_common.linear_init(jax.random.PRNGKey(1), 24, 40, bias=bias, dtype=jnp.float32)
    if bias:
        rp["b"] = jnp.linspace(-1.0, 1.0, 40)
    x = np.random.default_rng(0).normal(size=(3, 5, 24)).astype(np.float32)
    lin = _load(common.Linear(24, 40, bias=bias, dtype=torch.float32, generator=GEN,
                              device=CPU), rp)
    assert tuple(lin.w.shape) == (24, 40)  # stored (d_in, d_out), applied as x @ w
    _close(lin(_t(x)), r_common.linear(rp, jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 7, 48)) * 3 + 1).astype(np.float32)
    rp = {"scale": jnp.asarray(rng.normal(size=(48,)), getattr(jnp, dtype))}
    if kind == "layernorm":
        rp["bias"] = jnp.asarray(rng.normal(size=(48,)), getattr(jnp, dtype))
    norm = _load(common.Norm(48, kind=kind, dtype=getattr(torch, dtype), device=CPU), rp)
    want = r_common.apply_norm(rp, jnp.asarray(x, getattr(jnp, dtype)), kind=kind)
    got = norm(_t(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # f32 statistics on both sides (population variance, eps 1e-6); bf16
    # rounds the output once (2^-8 relative, up to |y| ~ 10 here)
    _close(got, want, atol=2e-5 if dtype == "float32" else 4e-2)


def test_layernorm_uses_population_variance_and_eps_1e6():
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    norm = common.Norm(4, kind="layernorm", dtype=torch.float32, device=CPU)
    var = float(x.var(unbiased=False))
    want = (x - x.mean()) / np.sqrt(var + 1e-6)
    torch.testing.assert_close(norm(x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pos_shape", ["s", "bs"])
def test_rope_matches_reference(pos_shape):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
    pos = (np.arange(9) + 5 if pos_shape == "s"
           else rng.integers(0, 100, size=(2, 9))).astype(np.int32)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = common.apply_rope(_t(x), _t(pos), 1e4)
    # angles up to ~100 rad: cos/sin of f32 angles differ by ulps of the angle
    _close(got, want, atol=2e-5)


def test_rope_rotates_interleaved_pairs():
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0  # the pair (x0, x1) rotates by position * freq0 = 1 rad
    y = common.apply_rope(x, torch.tensor([1]))
    torch.testing.assert_close(y[0, 0, 0, :2], torch.tensor([np.cos(1.0), np.sin(1.0)],
                                                            dtype=torch.float32))
    assert float(y[..., 2:].abs().max()) == 0.0


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"), (True, "relu")])
def test_mlp_matches_reference(gated, act):
    rp = r_common.mlp_init(jax.random.PRNGKey(4), 32, 80, gated=gated, bias=False,
                           dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, 6, 32)).astype(np.float32)
    mlp = _load(common.MLP(32, 80, gated=gated, bias=False, act=act, dtype=torch.float32,
                           generator=GEN, device=CPU), rp)
    _close(mlp(_t(x)), r_common.mlp(rp, jnp.asarray(x), act=act), atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(common.activation("gelu")(_t(x)), jax.nn.gelu(jnp.asarray(x)), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_unembed_match_reference(dtype):
    rp = r_common.embed_init(jax.random.PRNGKey(5), 64, 24, dtype=getattr(jnp, dtype))
    emb = _load(common.Embed(64, 24, dtype=getattr(torch, dtype), generator=GEN,
                             device=CPU), rp)
    ids = np.random.default_rng(5).integers(0, 64, size=(3, 7))
    h = emb(torch.as_tensor(ids))
    _close(h, r_common.embed(rp, jnp.asarray(ids)), atol=0)
    logits = common.unembed(emb, h)
    assert logits.dtype == torch.float32  # bf16 operands, f32 accumulate and out
    want = r_common.unembed(rp, r_common.embed(rp, jnp.asarray(ids)))
    _close(logits, want, atol=1e-6)


def test_count_params_matches_the_reference_for_full_widths():
    """The published widths, counted on the meta device (no memory)."""
    for r_cfg, p_cfg in ((r_star_cfg.FULL, p_star_cfg.FULL),
                         (r_mamba_cfg.FULL, p_mamba_cfg.FULL)):
        shapes = jax.eval_shape(lambda: r_lm.init(jax.random.PRNGKey(0), r_cfg))
        model = lm.init(p_cfg, generator=GEN, device="meta")
        assert common.count_params(model) == r_common.count_params(shapes)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ACFG = dict(d_model=48, n_heads=6, n_kv_heads=2, d_head=16, qkv_bias=True)


def _attn_pair(window):
    r_cfg = r_attention.AttnConfig(**ACFG, window=window)
    p_cfg = attention.AttnConfig(**ACFG, window=window)
    rp = r_attention.init(jax.random.PRNGKey(6), r_cfg, jnp.float32)
    rp = jax.tree_util.tree_map(lambda a: a + 0.01, rp)  # nonzero biases
    mod = _load(attention.init(p_cfg, torch.float32, generator=GEN, device=CPU), rp)
    return r_cfg, p_cfg, rp, mod


def _cache_close(pc, rc, atol):
    _close(pc["k"], rc["k"], atol)
    _close(pc["v"], rc["v"], atol)
    assert pc["idx"] == int(rc["idx"])


@pytest.mark.parametrize("window,s,max_len", [(None, 13, 20), (8, 13, 20), (16, 13, 20)])
def test_attention_prefill_then_decode_matches_reference(window, s, max_len):
    """Prefill with ``return_cache`` (the ring layout when s > window), then
    three decode steps against the cache: outputs and caches."""
    r_cfg, p_cfg, rp, mod = _attn_pair(window)
    rng = np.random.default_rng(s + (window or 0))
    x = rng.normal(size=(2, s, 48)).astype(np.float32)
    r_out, r_cache = r_attn_forward(rp, r_cfg, jnp.asarray(x), return_cache=True,
                                     max_cache_len=max_len)
    p_out, p_cache = attention.forward(mod, p_cfg, _t(x), return_cache=True,
                                       max_cache_len=max_len)
    _close(p_out, r_out, atol=1e-5)
    _cache_close(p_cache, r_cache, atol=1e-5)
    assert p_cache["k"].shape[2] == attention.cache_len(p_cfg, max_len)
    for step in range(3):
        xt = rng.normal(size=(2, 1, 48)).astype(np.float32)
        r_out, r_cache = r_attn_decode(rp, r_cfg, jnp.asarray(xt), r_cache)
        p_out, p_cache = attention.decode_step(mod, p_cfg, _t(xt), p_cache)
        _close(p_out, r_out, atol=1e-5)
        _cache_close(p_cache, r_cache, atol=1e-5)


def test_attention_cross_decode_matches_reference():
    """Cross-attention: ``forward`` over an external source (no RoPE, no
    causal mask), and one decode step against a static encoder cache."""
    r_cfg, p_cfg, rp, mod = _attn_pair(None)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    src = rng.normal(size=(2, 9, 48)).astype(np.float32)
    _close(attention.forward(mod, p_cfg, _t(x), kv_input=_t(src)),
           r_attention.forward(rp, r_cfg, jnp.asarray(x), kv_input=jnp.asarray(src)),
           atol=1e-5)
    cache = {"k": rng.normal(size=(2, 2, 10, 16)).astype(np.float32),
             "v": rng.normal(size=(2, 2, 10, 16)).astype(np.float32), "idx": 7}
    x = rng.normal(size=(2, 1, 48)).astype(np.float32)
    want = r_attention.cross_decode_step(
        rp, r_cfg, jnp.asarray(x),
        {"k": jnp.asarray(cache["k"]), "v": jnp.asarray(cache["v"]),
         "idx": jnp.asarray(7, jnp.int32)})
    got = attention.cross_decode_step(
        mod, p_cfg, _t(x), {"k": _t(cache["k"]), "v": _t(cache["v"]), "idx": 7})
    _close(got, want, atol=1e-5)


def test_attention_make_cache_is_ring_sized_for_windows():
    cfg = attention.AttnConfig(**ACFG, window=8)
    cache = attention.make_cache(cfg, 3, 100, torch.bfloat16, CPU)
    assert tuple(cache["k"].shape) == (3, 2, 8, 16) and cache["k"].dtype == torch.bfloat16
    assert cache["idx"] == 0
    assert attention.cache_len(attention.AttnConfig(**ACFG), 100) == 100


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,g", [(40, 1), (21, 2)])
def test_mamba2_forward_then_decode_matches_reference(s, g):
    r_cfg = r_mamba2.Mamba2Config(d_model=32, d_inner=64, d_state=16, head_dim=16,
                                  n_groups=g)
    p_cfg = mamba2.Mamba2Config(d_model=32, d_inner=64, d_state=16, head_dim=16,
                                n_groups=g)
    rp = r_mamba2.init(jax.random.PRNGKey(9), r_cfg, jnp.float32)
    rp = dict(rp, conv_b=rp["conv_b"] + 0.05, D=rp["D"] * 0.7)
    mod = _load(mamba2.init(p_cfg, torch.float32, generator=GEN, device=CPU), rp)
    for name in ("dt_bias", "A_log", "D"):
        assert getattr(mod, name).dtype == torch.float32
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    r_y, r_st = r_mamba_forward(rp, r_cfg, jnp.asarray(x), return_state=True)
    p_y, p_st = mamba2.forward(mod, p_cfg, _t(x), return_state=True)
    _close(p_y, r_y, atol=2e-5)
    _close(p_st["conv"], r_st["conv"], atol=1e-6)
    _close(p_st["ssm"], r_st["ssm"], atol=2e-5)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, 32)).astype(np.float32)
        r_y, r_st = r_mamba_decode(rp, r_cfg, jnp.asarray(xt), r_st)
        p_y, p_st = mamba2.decode_step(mod, p_cfg, _t(xt), p_st)
        _close(p_y, r_y, atol=2e-5)
        _close(p_st["conv"], r_st["conv"], atol=1e-6)
        _close(p_st["ssm"], r_st["ssm"], atol=2e-5)


def test_mamba2_causal_conv_sums_taps_in_order():
    w = torch.tensor([[1.0], [10.0], [100.0]])
    x = torch.tensor([[[1.0], [2.0], [3.0]]])
    out, state = mamba2._causal_conv(w, torch.zeros(1), x)
    # out_t = silu(w0 x_{t-2} + w1 x_{t-1} + w2 x_t)
    pre = torch.tensor([[[100.0], [210.0], [321.0]]])
    torch.testing.assert_close(out, torch.nn.functional.silu(pre))
    torch.testing.assert_close(state, torch.tensor([[[2.0], [3.0]]]))


# ---------------------------------------------------------------------------
# the whole LM
# ---------------------------------------------------------------------------

LOCAL_R = r_lm.LMConfig(
    name="local-smoke", vocab=128, d_model=32, n_layers=4, pattern=("local", "attn"),
    attn=r_attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=8),
    local_window=6, d_ff=64, norm="rmsnorm", act="silu", scale_embeddings=True,
    tie_embeddings=False, dtype=jnp.float32)
LOCAL_P = lm.LMConfig(
    name="local-smoke", vocab=128, d_model=32, n_layers=4, pattern=("local", "attn"),
    attn=attention.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=8),
    local_window=6, d_ff=64, norm="rmsnorm", act="silu", scale_embeddings=True,
    tie_embeddings=False, dtype=torch.float32)

LM_CASES = {
    "starcoder2": (r_star_cfg.SMOKE, p_star_cfg.SMOKE),
    "mamba2": (r_mamba_cfg.SMOKE, p_mamba_cfg.SMOKE),
    "local+attn": (LOCAL_R, LOCAL_P),
    "gemma3": (r_gemma_cfg.SMOKE, p_gemma_cfg.SMOKE),
    "granite-moe": (r_gmoe_cfg.SMOKE, p_gmoe_cfg.SMOKE),
}


def _ref_layer_caches(r_cfg, r_caches):
    """The reference's caches (one stack per pattern position, leading
    n_groups axis) as a list per layer."""
    out = []
    for gi in range(r_cfg.n_groups):
        for i in range(len(r_cfg.pattern)):
            out.append({k: np.asarray(v)[gi] for k, v in r_caches[i].items()})
    return out


def _lm_caches_close(p_caches, r_cfg, r_caches, atol):
    ref = _ref_layer_caches(r_cfg, r_caches)
    assert len(p_caches) == len(ref) == r_cfg.n_layers
    for pc, rc in zip(p_caches, ref):
        assert set(pc) == set(rc)
        for key in pc:
            if key == "idx":
                assert pc["idx"] == int(rc["idx"])
            else:
                _close(pc[key], rc[key], atol=atol)


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_prefill_and_decode_match_reference(case):
    """Prefill logits and caches, then four greedy decode steps: each
    step's logits, caches and token (both sides fed the reference's)."""
    r_cfg, p_cfg = LM_CASES[case]
    params = r_lm.init(jax.random.PRNGKey(11), r_cfg)
    model = convert.lm_params_from_reference(_np(params), p_cfg, CPU)
    prompt = np.random.default_rng(12).integers(0, r_cfg.vocab, (2, 19)).astype(np.int32)
    max_len = 19 + 4 + 8
    r_caches, r_logits = r_lm_prefill(r_cfg, params, jnp.asarray(prompt),
                                      max_cache_len=max_len)
    p_caches, p_logits = lm.prefill(p_cfg, model, torch.as_tensor(prompt, dtype=torch.long),
                                    max_cache_len=max_len)
    assert tuple(p_logits.shape) == (2, 1, r_cfg.vocab) and p_logits.dtype == torch.float32
    _close(p_logits, r_logits, atol=2e-5)
    _lm_caches_close(p_caches, r_cfg, r_caches, atol=2e-5)
    tok = jnp.argmax(r_logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for _ in range(4):
        p_tok = torch.argmax(p_logits[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(tok))
        r_caches, r_logits = r_lm_decode(r_cfg, params, r_caches, tok)
        p_caches, p_logits = lm.decode_step(p_cfg, model, p_caches,
                                            torch.as_tensor(np.array(tok), dtype=torch.long))
        _close(p_logits, r_logits, atol=2e-5)
        _lm_caches_close(p_caches, r_cfg, r_caches, atol=2e-5)
        tok = jnp.argmax(r_logits[:, -1], axis=-1).astype(jnp.int32)[:, None]


@pytest.mark.parametrize("case", ["starcoder2", "mamba2", "gemma3", "granite-moe"])
def test_lm_forward_matches_reference(case):
    """Logits, and the MoE layers' summed aux losses (zero without them)."""
    r_cfg, p_cfg = LM_CASES[case]
    params = r_lm.init(jax.random.PRNGKey(13), r_cfg)
    model = convert.lm_params_from_reference(_np(params), p_cfg, CPU)
    tokens = np.random.default_rng(13).integers(0, r_cfg.vocab, (2, 24)).astype(np.int32)
    r_logits, r_aux = r_lm_forward(r_cfg, params, jnp.asarray(tokens))
    p_logits, p_aux = lm.forward(p_cfg, model, torch.as_tensor(tokens, dtype=torch.long))
    _close(p_logits, r_logits, atol=2e-5)
    for key in ("lb", "z"):
        assert float(p_aux[key]) == pytest.approx(float(r_aux[key]), rel=1e-5, abs=1e-6)
    if p_cfg.moe_cfg is None:
        assert float(p_aux["lb"]) == float(r_aux["lb"]) == 0.0


def test_lm_init_caches_match_reference_shapes():
    r_cfg, p_cfg = LM_CASES["local+attn"]
    ref = _ref_layer_caches(r_cfg, r_lm.init_caches(r_cfg, 3, 20))
    got = lm.init_caches(p_cfg, 3, 20, CPU)
    assert [{k: tuple(np.shape(v)) for k, v in c.items() if k != "idx"} for c in got] == \
           [{k: v.shape for k, v in c.items() if k != "idx"} for c in ref]


@pytest.mark.parametrize("change,item", [(dict(shared_attn=True), "A8c"),
                                         (dict(vision=(4, 8)), "A8d")])
def test_unported_block_kinds_raise_and_name_the_roadmap_item(change, item):
    """The two LM options ROADMAP A8c and A8d ported, on starcoder2-smoke's
    attention stack: a shared block before each layer (A8c), and 4 image
    patches of width 8 prepended (A8d). Logits within 2e-5 of the
    reference's, and the option's own parameters present."""
    r_cfg = dataclasses.replace(r_star_cfg.SMOKE, **{
        k: r_lm.VisionStub(*v) if k == "vision" else v for k, v in change.items()})
    p_cfg = dataclasses.replace(p_star_cfg.SMOKE, **{
        k: lm.VisionStub(*v) if k == "vision" else v for k, v in change.items()})
    params = r_lm.init(jax.random.PRNGKey(13), r_cfg)
    model = convert.lm_params_from_reference(_np(params), p_cfg, CPU)
    assert (model.shared is None) == (item != "A8c")
    assert (model.vision_proj is None) == (item != "A8d")
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, r_cfg.vocab, (2, 11)).astype(np.int32)
    images = rng.normal(size=(2, 4, 8)).astype(np.float32) if item == "A8d" else None
    r_logits, _ = r_lm_forward(r_cfg, params, jnp.asarray(tokens),
                               None if images is None else jnp.asarray(images))
    with torch.no_grad():
        logits, _ = lm.forward(p_cfg, model, _t(tokens, torch.long),
                               None if images is None else _t(images))
    assert tuple(logits.shape) == (2, 11 + (4 if item == "A8d" else 0), r_cfg.vocab)
    _close(logits, r_logits, atol=2e-5)


def test_port_weights_come_from_a_torch_generator():
    """The same seed gives the same weights; the init scheme matches the
    reference's (normal * 0.02, ones / zeros for norms, f32 SSM params)."""
    a = lm.init(p_mamba_cfg.SMOKE, generator=torch.Generator().manual_seed(0), device=CPU)
    b = lm.init(p_mamba_cfg.SMOKE, generator=torch.Generator().manual_seed(0), device=CPU)
    for (na, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(ta, tb), na
    std = float(a.embed.table.std())
    assert 0.018 < std < 0.022
    assert torch.equal(a.final_norm.scale, torch.ones(64))
    A = -torch.exp(a.blocks[0].mamba.A_log)
    assert float(A.max()) <= -1.0 and float(A.min()) >= -16.0
