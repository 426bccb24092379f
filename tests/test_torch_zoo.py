"""Port parity, the model zoo: the dense and MoE configs, the analytic
roofline and the whole LM of each new arch against the JAX package, on the
CPU.

The reference's weights are carried across (``convert``) and both packages
run the same inputs, made from a numpy seed. Float32 SMOKE widths: logits
within 2e-5 (the tolerance of ``test_torch_models.py``), greedy tokens
equal; the loss within 1e-6 relative and every gradient within 1e-5 of
its scale, both packages summing in different orders. Parameter counts
and roofline terms are exact: the same integer count, then the same float
arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs.base import SHAPES as R_SHAPES
from repro.core import engine as r_engine
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro_torch import configs, convert
from repro_torch.configs.base import SHAPES
from repro_torch.core import engine
from repro_torch.core.power import PowerModel
from repro_torch.launch import steps
from repro_torch.models import common, lm

CPU = torch.device("cpu")
NEW_ARCHS = ("granite-20b", "qwen1.5-110b", "gemma3-12b", "granite-moe-1b-a400m",
             "phi3.5-moe-42b-a6.6b")
# the reference's parameter counts at full width (jax.eval_shape of
# arch.init(PRNGKey(0), arch.full)), as the port must reproduce them
FULL_PARAMS = {
    "granite-20b": 20_014_411_776,
    "qwen1.5-110b": 111_209_914_368,
    "gemma3-12b": 11_765_395_200,
    "granite-moe-1b-a400m": 1_334_628_352,
    "phi3.5-moe-42b-a6.6b": 41_872_793_600,
    "starcoder2-3b": 3_029_818_368,
    "mamba2-130m": 128_983_488,
    "zamba2-7b": 6_699_343_696,
    "phi-3-vision-4.2b": 3_824_225_280,
    "whisper-medium": 758_707_200,
}
ATOL = 2e-5

r_prefill = jax.jit(r_lm.prefill, static_argnums=(0,), static_argnames=("max_cache_len",))
r_decode = jax.jit(r_lm.decode_step, static_argnums=(0,))
r_forward = jax.jit(r_lm.forward, static_argnums=(0,))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch_id, which="smoke"):
    return (getattr(r_configs.get_arch(arch_id), which),
            getattr(configs.get_arch(arch_id), which))


def _model(arch_id, seed, r_cfg=None, p_cfg=None):
    if r_cfg is None:
        r_cfg, p_cfg = _pair(arch_id)
    params = r_lm.init(jax.random.PRNGKey(seed), r_cfg)
    return r_cfg, p_cfg, params, convert.lm_params_from_reference(_np(params), p_cfg, CPU)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------


def test_registry_covers_every_reference_arch():
    assert sorted([*configs.ARCHS, *configs.NOT_PORTED]) == sorted(r_configs.ARCHS)
    assert set(NEW_ARCHS) <= set(configs.ARCHS)
    assert set(FULL_PARAMS) == set(configs.ARCHS)


@pytest.mark.parametrize("arch_id", sorted(FULL_PARAMS))
def test_meta_parameter_count_equals_the_reference(arch_id):
    """Counted on the meta device (nothing allocated, no generator), equal
    to ``jax.eval_shape``'s count of the reference's init (zamba2's shared
    block once, whisper through ``encdec.init``)."""
    arch, r_arch = configs.get_arch(arch_id), r_configs.get_arch(arch_id)
    shapes = jax.eval_shape(lambda: r_arch.init(jax.random.PRNGKey(0), r_arch.full))
    model = arch.init(None, arch.full, device="meta")
    assert common.count_params(model) == r_common.count_params(shapes) == FULL_PARAMS[arch_id]
    assert all(p.device.type == "meta" for p in model.parameters())


# ---------------------------------------------------------------------------
# the analytic roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", sorted(FULL_PARAMS) + ["no-such-arch"])
def test_terms_analytic_equals_the_reference(arch_id):
    """Every shape cell: ``dataclasses.astuple`` equal. An id outside the
    zoo counts 1e8 parameters in both."""
    for name in SHAPES:
        got = engine.terms_analytic(arch_id, SHAPES[name])
        want = r_engine.terms_analytic(arch_id, R_SHAPES[name])
        assert dataclasses.astuple(got) == dataclasses.astuple(want), name


def test_terms_analytic_of_gemma3_prefill_32k():
    got = engine.terms_analytic("gemma3-12b", SHAPES["prefill_32k"])
    assert dataclasses.astuple(got) == (0.16145227800950254, 0.00022446190476190476,
                                        0.04843568340285076, "analytic")


def test_terms_analytic_is_memoized_and_cleared():
    cell = SHAPES["train_4k"]
    eng = engine.PlanningEngine(PowerModel(1.0, 2.0, 3.0, 4.0), device=CPU)
    first = engine.terms_analytic("gemma3-12b", cell)
    assert engine.terms_analytic("gemma3-12b", cell) is first
    assert engine._ANALYTIC_TERMS_CACHE[("gemma3-12b", cell)] is first
    eng.clear_cache(analytic=False)  # this engine's fits only
    assert engine.terms_analytic("gemma3-12b", cell) is first
    eng.clear_cache()
    assert not engine._ANALYTIC_TERMS_CACHE
    again = engine.terms_analytic("gemma3-12b", cell)
    assert again is not first and dataclasses.astuple(again) == dataclasses.astuple(first)
    assert dataclasses.astuple(again) == dataclasses.astuple(
        r_engine.terms_analytic("gemma3-12b", R_SHAPES["train_4k"]))


# ---------------------------------------------------------------------------
# the whole LM at SMOKE width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", NEW_ARCHS)
def test_forward_matches_reference(arch_id):
    """Logits and the MoE aux losses (zero for the dense archs)."""
    r_cfg, p_cfg, params, model = _model(arch_id, 31)
    tokens = np.random.default_rng(31).integers(0, r_cfg.vocab, (2, 24)).astype(np.int32)
    r_logits, r_aux = r_forward(r_cfg, params, jnp.asarray(tokens))
    with torch.no_grad():
        logits, aux = lm.forward(p_cfg, model, torch.as_tensor(tokens, dtype=torch.long))
    _close(logits, r_logits)
    for key in ("lb", "z"):
        assert float(aux[key]) == pytest.approx(float(r_aux[key]), rel=1e-5, abs=1e-6), key
    if p_cfg.moe_cfg is None:
        assert float(aux["lb"]) == float(aux["z"]) == 0.0
    else:
        assert float(aux["lb"]) > 0 and float(aux["z"]) > 0


@pytest.mark.parametrize("arch_id", NEW_ARCHS)
def test_prefill_and_eight_decode_steps_match_reference(arch_id):
    """A 24-token prompt (gemma3-smoke's local layers, window 8, keep a ring
    of 8 slots that the prompt overfills), then 8 greedy decode steps: each
    step's logits, and the tokens equal."""
    r_cfg, p_cfg, params, model = _model(arch_id, 32)
    prompt = np.random.default_rng(32).integers(0, r_cfg.vocab, (2, 24)).astype(np.int32)
    max_len = 24 + 8 + 8
    r_caches, r_logits = r_prefill(r_cfg, params, jnp.asarray(prompt), max_cache_len=max_len)
    with torch.no_grad():
        caches, logits = lm.prefill(p_cfg, model, torch.as_tensor(prompt, dtype=torch.long),
                                    max_cache_len=max_len)
        _close(logits, r_logits)
        for _ in range(8):
            tok = np.asarray(jnp.argmax(r_logits[:, -1], axis=-1).astype(jnp.int32))[:, None]
            np.testing.assert_array_equal(steps.greedy(logits).numpy(), tok)
            r_caches, r_logits = r_decode(r_cfg, params, r_caches, jnp.asarray(tok))
            caches, logits = lm.decode_step(p_cfg, model, caches,
                                            torch.as_tensor(np.array(tok), dtype=torch.long))
            _close(logits, r_logits)
    if p_cfg.local_window:
        local = [c for c, kind in zip(caches, p_cfg.kinds()) if kind == "local"]
        assert {c["k"].shape[2] for c in local} == {p_cfg.local_window} and local[0]["idx"] == 32


@pytest.mark.parametrize("arch_id", ["granite-moe-1b-a400m", "gemma3-12b"])
def test_loss_and_every_gradient_match_reference(arch_id):
    """``loss_fn`` (cross-entropy plus the MoE terms) and its gradient for
    every parameter, against ``jax.value_and_grad``; the port's forward
    recomputes each layer (``torch.utils.checkpoint``) as the reference's
    remat does."""
    r_cfg, p_cfg, params, model = _model(arch_id, 33)
    rng = np.random.default_rng(33)
    batch = {k: rng.integers(0, r_cfg.vocab, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    (r_loss, r_parts), r_grads = jax.value_and_grad(
        lambda p: r_lm.loss_fn(r_cfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(params)
    steps.trainable(model)
    arch = configs.get_arch(arch_id)
    loss, parts, grads = steps.loss_and_grads(arch, p_cfg, model,
                                              steps.batch_to_torch(batch, CPU))
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-6)
    for key in ("ce", "lb", "z"):
        assert float(parts[key]) == pytest.approx(float(r_parts[key]), rel=1e-5, abs=1e-7), key
    if p_cfg.moe_cfg is not None:
        assert float(parts["lb"]) > 0 and float(parts["z"]) > 0
    want = {}
    for i, stack in enumerate(r_grads["blocks"]):
        for path, arr in convert.flatten_reference(_np(stack)).items():
            for g in range(r_cfg.n_groups):
                want[f"blocks.{g * len(r_cfg.pattern) + i}.{path}"] = arr[g]
    want.update(convert.flatten_reference(_np({k: v for k, v in r_grads.items()
                                               if k != "blocks"})))
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = max(float(np.abs(want[name]).max()), 1e-3)
        _close(g, want[name], atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# carrying the reference's stacked weights across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id,n_layers", [("gemma3-12b", 12), ("granite-moe-1b-a400m", 3),
                                              ("phi3.5-moe-42b-a6.6b", 4)])
def test_stacked_weights_land_on_their_layers(arch_id, n_layers):
    """Group g's slice of pattern position i's stack is layer g·len(pattern)
    + i, the experts' (n_groups, E, d, d_ff) stacks included (gemma3's
    pattern of 6 over 2 groups here)."""
    r_cfg, p_cfg = (dataclasses.replace(c, n_layers=n_layers) for c in _pair(arch_id))
    _, _, params, model = _model(arch_id, 34, r_cfg, p_cfg)
    n_pat = len(r_cfg.pattern)
    for layer, blk in enumerate(model.blocks):
        g, i = divmod(layer, n_pat)
        stack = params["blocks"][i]
        np.testing.assert_array_equal(blk.attn.q.w.numpy(), np.asarray(stack["attn"]["q"]["w"][g]))
        if p_cfg.kinds()[layer] == "moe":
            for name in ("up", "gate", "down"):
                want = np.asarray(stack["moe"]["experts"][name]["w"][g])
                got = getattr(blk.moe.experts, name).w.numpy()
                assert got.shape == want.shape and got.shape[0] == p_cfg.moe_cfg.n_experts
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(blk.moe.router.w.numpy(),
                                          np.asarray(stack["moe"]["router"]["w"][g]))
            assert blk.moe.router.w.dtype == torch.float32
        else:
            np.testing.assert_array_equal(blk.mlp.up.w.numpy(),
                                          np.asarray(stack["mlp"]["up"]["w"][g]))


def _flat(tree):
    """``flatten_reference`` of an LM tree, ``blocks.<i>.`` by position."""
    return convert.flatten_reference(dict(tree, blocks=dict(enumerate(tree["blocks"]))))


def test_seeded_reference_params_round_trip():
    """The golden's seeded weights: the same seed, the same tree; shapes
    and names as given; ``unflatten_reference`` inverts the flattening."""
    r_cfg, p_cfg = _pair("granite-moe-1b-a400m")
    shapes = {k: list(v.shape)
              for k, v in _flat(_np(r_lm.init(jax.random.PRNGKey(0), r_cfg))).items()}
    a = convert.seeded_reference_params(shapes, 5)
    flat = _flat(a)
    assert {k: list(v.shape) for k, v in flat.items()} == shapes
    assert all(np.array_equal(flat[k], v)
               for k, v in _flat(convert.seeded_reference_params(shapes, 5)).items())
    assert _flat(convert.unflatten_reference(flat)).keys() == flat.keys()
    model = convert.lm_params_from_reference(a, p_cfg, CPU)
    assert float(model.final_norm.scale.std()) > 0.05  # 1 + N(0, 0.1^2)


# ---------------------------------------------------------------------------
# the serving golden chip_smoke.py holds the card to (phase 6a)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """A private copy of ``chip_smoke.py``."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch_id", NEW_ARCHS + ("zamba2-7b", "phi-3-vision-4.2b",
                                                 "whisper-medium"))
def test_serve_golden_is_the_live_reference_and_the_port_meets_it(arch_id, smoke):
    """The committed golden's arrays equal what the reference computes now
    (its weights named by seed); the port, on the weights chip_smoke.py
    draws from that seed (and the golden's whisper frames or phi-3-vision
    patches), meets it on the host as the card must: logits within
    SERVE_GOLDEN_ATOL, greedy tokens equal."""
    from helpers.make_torch_port_serve_golden import golden
    from repro_torch.launch import serve

    committed = np.load(smoke.SERVE_GOLDEN)
    live = golden(arch_id)
    assert sorted(live) == sorted(k for k in committed.files if k.startswith(f"{arch_id}/"))
    for key, val in live.items():
        np.testing.assert_array_equal(committed[key], val, err_msg=key)
    arch = configs.get_arch(arch_id)
    model = convert.params_from_reference(smoke._reference_params(committed, arch_id),
                                          arch.smoke, CPU)
    want_tokens = committed[f"{arch_id}/tokens"]
    out = serve.run(arch, arch.smoke, model, committed[f"{arch_id}/prompts"],
                    want_tokens.shape[1], **smoke._serve_extras(committed, arch_id))
    np.testing.assert_array_equal(out.tokens.numpy(), want_tokens)
    _close(out.prefill_logits, committed[f"{arch_id}/prefill_logits"], smoke.SERVE_GOLDEN_ATOL)
    _close(torch.stack(out.step_logits), committed[f"{arch_id}/step_logits"],
           smoke.SERVE_GOLDEN_ATOL)
    assert float(committed[f"{arch_id}/min_top2_gap"]) > 2 * smoke.SERVE_GOLDEN_ATOL
