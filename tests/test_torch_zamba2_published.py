"""Zamba2-7B's published layout (``configs.zamba2_7b.PUBLISHED``) against the
benchmark's plain float32 reference (``chipbench/reference/zamba2.py``), on
the CPU at ``PUBLISHED_SMOKE`` widths: two shared blocks called in turn at
three hybrid layers, each call with its own adapter and linear.

Both sides take the same weights, drawn from a seed by the benchmark
(``chipbench.inputs``) under the reference's names, which the port's
``named_parameters`` give too, with the SMOKE file's std of 0.1: at these
widths it keeps a shared call's part of the logits near the trunk's, as
0.02 does at the published widths. Tolerances are those of the zoo's parity
tests: logits within 2e-5, greedy tokens equal; the loss within 1e-6
relative and every gradient within 1e-5 of its scale, the two sides
summing in different orders. This file imports no ``jax``.
"""

import json
import math
import os

import pytest
import torch

from chipbench import inputs, port
from chipbench.reference import lm as ref_lm
from chipbench.reference import zamba2 as ref_zamba2
from chipbench.reference.precision import Precision, strict_float32
from repro_torch import obs
from repro_torch.configs import zamba2_7b
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import PADDED_HEAD_DIMS, flash_attention_cuda
from repro_torch.launch import steps
from repro_torch.models import common, lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "chipbench", "configs", "zamba2-7b.json")
SMOKE = os.path.join(ROOT, "chipbench", "tests", "data", "smoke-zamba2.json")
F32 = Precision("float32")
ATOL = 2e-5


def _file(path, **changes):
    with open(path) as f:
        return dict(json.load(f), **changes)


def _setup(seed=5):
    """(file, the port's config, its model, the reference's weights)."""
    strict_float32()
    cfg = _file(SMOKE, torch_dtype="float32")
    arch, lm_cfg = port.arch_and_config(cfg)
    weights = inputs.draw_weights(ref_lm.param_specs(cfg), cfg, seed, "cpu", torch.float32)
    model = port.build_model(arch, lm_cfg, {k: w.clone() for k, w in weights.items()})
    return cfg, lm_cfg, model, weights


def _tokens(seed, rows, cols, index=0):
    return inputs.tokens(seed, index, rows, cols, zamba2_7b.PUBLISHED_SMOKE.vocab, "cpu")


def _reference_logits(cfg, weights, toks):
    with torch.no_grad():
        h, _ = ref_lm.hidden(cfg, weights, toks, F32)
        return ref_lm.logits(cfg, weights, h, F32)


def _close(got, want, atol=ATOL):
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_the_file_gives_the_published_config_and_its_weights():
    """The configuration file, through the adapter, is ``PUBLISHED``; the
    SMOKE file is ``PUBLISHED_SMOKE``; both sides count 7,356,749,648
    weights, the shared blocks' once."""
    _, got = port.arch_and_config(_file(CONFIG))
    assert got == zamba2_7b.PUBLISHED
    _, smoke = port.arch_and_config(_file(SMOKE, torch_dtype="float32"))
    assert smoke == zamba2_7b.PUBLISHED_SMOKE
    model = lm.init(zamba2_7b.PUBLISHED, generator=None, device="meta")
    assert common.count_params(model) == 7_356_749_648
    specs = ref_lm.param_specs(_file(CONFIG))
    assert sum(math.prod(shape) for _, shape, _ in specs) == 7_356_749_648
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        {n: shape for n, shape, _ in specs}


def test_the_layout_calls_two_blocks_in_turn():
    assert lm.shared_calls(zamba2_7b.PUBLISHED_SMOKE) == {1: (0, 0), 3: (1, 1), 6: (2, 0)}
    calls = lm.shared_calls(zamba2_7b.PUBLISHED)
    assert sorted(calls) == [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77]
    assert [calls[i] for i in (6, 11, 77)] == [(0, 0), (1, 1), (12, 0)]
    # the JAX package's layout: one block before every group of 3 layers
    assert lm.shared_calls(zamba2_7b.FULL) == {3 * g: (g, 0) for g in range(27)}


def test_teacher_forced_logits_match_the_reference():
    cfg, lm_cfg, model, weights = _setup()
    toks = _tokens(5, 2, 40)
    with torch.no_grad():
        logits, _ = lm.forward(lm_cfg, model, toks)
    want = _reference_logits(cfg, weights, toks)
    _close(logits, want)
    assert torch.equal(steps.greedy(logits), torch.argmax(want[:, -1], dim=-1)[:, None])


def test_the_hybrid_calls_move_the_logits():
    """Each call's adapter and linear reach the output: zeroing one call's
    linear changes the logits after its layer."""
    cfg, lm_cfg, model, weights = _setup()
    toks = _tokens(5, 2, 24)
    with torch.no_grad():
        before, _ = lm.forward(lm_cfg, model, toks)
        model.blocks[3].linear.w.zero_()
        after, _ = lm.forward(lm_cfg, model, toks)
    assert (before - after).abs().max() > 0.1 * before.abs().max()


def test_prefill_then_four_decode_steps_match_the_full_forward():
    """A 28-token prompt, then 4 greedy steps through the 13-call cache
    layout (here 3 calls): each step's logits against the reference's full
    forward over the tokens so far, and the tokens equal."""
    cfg, lm_cfg, model, weights = _setup()
    toks = _tokens(6, 2, 28)
    max_len = 32
    with torch.no_grad():
        caches, logits = lm.prefill(lm_cfg, model, toks, max_cache_len=max_len)
        assert len(caches) == lm_cfg.n_layers + 3
        shared = caches[lm_cfg.n_layers:]
        assert [c["idx"] for c in shared] == [28] * 3
        assert shared[0]["k"].shape == (2, 4, max_len, 32)
        for step in range(4):
            want = _reference_logits(cfg, weights, toks)[:, -1:]
            _close(logits, want)
            nxt = steps.greedy(logits)
            assert torch.equal(nxt, torch.argmax(want[:, -1], dim=-1)[:, None])
            toks = torch.cat([toks, nxt], dim=1)
            caches, logits = lm.decode_step(lm_cfg, model, caches, nxt)
        _close(logits, _reference_logits(cfg, weights, toks)[:, -1:])
    # the last call's cache is the reference's last_kv_layer's k and v
    assert ref_lm.last_kv_layer(cfg) == 6
    with torch.no_grad():
        _, (k, v) = ref_lm.hidden(cfg, weights, toks, F32, kv_layer=6)
    _close(caches[-1]["k"], k)
    _close(caches[-1]["v"], v)


def test_loss_and_every_gradient_match_the_reference(monkeypatch):
    """``loss_fn`` and the gradient of every parameter against the
    reference's, each layer and each shared call recomputed in the
    backward. Block 0 serves calls 0 and 2: its gradient is the sum of
    what the two calls give it."""
    cfg, lm_cfg, model, weights = _setup(7)
    toks, labels = _tokens(7, 2, 24), _tokens(7, 2, 24, index=1)
    steps.trainable(model)
    loss, _, grads = steps.loss_and_grads(zamba2_7b.ARCH, lm_cfg, model,
                                          {"tokens": toks, "labels": labels})

    def reference_grads():
        params = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
        total = ref_lm.loss(cfg, params, toks, labels, F32)
        return total, dict(zip(params, torch.autograd.grad(total, list(params.values()))))

    want_loss, want = reference_grads()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = max(float(want[name].abs().max()), 1e-3)
        _close(g, want[name], atol=1e-5 * scale)

    # the reference with call 2 on its own copy of block 0: the two parts
    # add up to the shared tensor's gradient
    hook = ref_zamba2.layer_params
    copies = {}

    def untied(params, i):
        p = hook(params, i)
        if i == 6:
            for k in [k for k in p if k.startswith("shared.")]:
                if k not in copies:
                    copies[k] = p[k].detach().clone().requires_grad_(True)
                p[k] = copies[k]
        return p

    monkeypatch.setattr(ref_zamba2, "layer_params", untied)
    params = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    total = ref_lm.loss(cfg, params, toks, labels, F32)
    names = [k for k in params if k.startswith("shared.0.")]
    parts = torch.autograd.grad(total, [params[k] for k in names]
                                + [copies["shared." + k[len("shared.0."):]] for k in names])
    for name, first, second in zip(names, parts[:len(names)], parts[len(names):]):
        assert torch.linalg.vector_norm(second) > 0
        scale = max(float(want[name].abs().max()), 1e-3)
        _close(first + second, want[name], atol=1e-5 * scale)
        _close(grads[name], first + second, atol=1e-5 * scale)


@pytest.mark.parametrize("causal, sq, skv, q_offset, kv_len",
                         [(True, 20, 20, 0, None), (False, 1, 24, 19, 20)])
def test_head_dim_224_is_padded_to_256_with_its_own_scale(causal, sq, skv, q_offset, kv_len):
    """The wrapper takes d 224 by zero-padding to the d 256 instance: on the
    plain path the padded call, cut back, is the call at d 224, with the
    scale (224 / 2)^-1/2 given; prefill and decode."""
    assert PADDED_HEAD_DIMS[224] == 256
    gen = torch.Generator().manual_seed(224)
    q, k, v = (torch.randn(shape, generator=gen)
               for shape in ((2, 4, sq, 224), (2, 4, skv, 224), (2, 4, skv, 224)))
    kw = dict(causal=causal, window=None, scale=112**-0.5, q_offset=q_offset, kv_len=kv_len)
    want = ref.flash_attention_ref(q, k, v, **kw)
    padded = [torch.nn.functional.pad(t, (0, 32)) for t in (q, k, v)]
    got = ref.flash_attention_ref(*padded, **kw)[..., :224]
    _close(got, want, atol=1e-6)
    # the kernel's wrapper takes the head dim: it refuses host tensors, not d 224
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k, v, **kw)


def test_shared_calls_are_spans_and_a_counter_only_under_a_recorder():
    """``lm.shared`` spans (call, block) and ``lm.shared_calls`` in forward,
    prefill and decode; without a recorder nothing is recorded, and the
    numbers are bitwise the same either way."""
    _, lm_cfg, model, _ = _setup()
    toks = _tokens(8, 2, 16)

    def run():
        with torch.no_grad():
            logits, _ = lm.forward(lm_cfg, model, toks)
            caches, last = lm.prefill(lm_cfg, model, toks, max_cache_len=17)
            _, step = lm.decode_step(lm_cfg, model, caches, steps.greedy(last))
        return logits, last, step

    plain = run()
    assert obs.tracer().events() == [] and obs.metrics_registry().snapshot()["counters"] == {}
    with obs.recording() as rec:
        recorded = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, recorded))
    spans = [e for e in rec.trace.events() if e["name"] == "lm.shared"]
    assert {e["cat"] for e in spans} == {"model"}
    calls = [(e["args"]["call"], e["args"]["block"]) for e in spans]
    assert calls == [(0, 0), (1, 1), (2, 0)] * 3
    assert rec.metrics.snapshot()["counters"]["lm.shared_calls"] == 9

