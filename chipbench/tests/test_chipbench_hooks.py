"""The family hooks of the plain reference, and the prefill entry's pairing
of the port's last attention cache with the reference's layer, on the CPU.

A toy family, which exists only here, shares one attention block between
its two layers and has each layer read the embedding's output ``h0``
besides its input (the shape of a hybrid model with a shared block). It
is put into ``sys.modules`` as ``chipbench.reference.<name>``. The
families without hooks (``dense``,
``mamba2``) have to run exactly as a loop over their ``blocks.{i}.``
slices.
"""

import sys
import time
import types

import pytest
import torch

from chipbench import calibrate, harness, inputs, port, spec
from chipbench.entries import prefill
from chipbench.reference import lm
from chipbench.reference import train as ref_train
from chipbench.reference.precision import Precision
from chipbench.tests import smoke

F32 = Precision("float32")
CFG = {"family": "toy_shared", "arch": "toy-shared", "d": 8, "heads": 2, "dh": 4, "vocab": 32,
       "norm_epsilon": 1e-6, "initializer_range": 0.2, "torch_dtype": "float32"}
SHARED = ("shared.in.w", "shared.q.w", "shared.k.w", "shared.v.w", "shared.o.w")
OPT = {"peak_lr": 1e-3, "warmup_steps": 0, "total_steps": 10, "end_lr_frac": 0.1, "b1": 0.9,
       "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0, "clip_norm": 1e9}


def _dims(cfg):
    return dict(d=cfg["d"], layers=2, vocab=cfg["vocab"], h=cfg["heads"], dh=cfg["dh"])


def _shared_specs(cfg, pre):
    d, hd = cfg["d"], cfg["heads"] * cfg["dh"]
    shapes = {"in": (2 * d, d), "q": (d, hd), "k": (d, hd), "v": (d, hd), "o": (hd, d)}
    return [(f"{pre}shared.{n}.w", shape, "normal") for n, shape in shapes.items()]


def _specs(cfg, tied):
    d = cfg["d"]
    out = [("embed.table", (cfg["vocab"], d), "normal")]
    out += _shared_specs(cfg, "") if tied else []
    for i in range(2):
        out += [(f"blocks.{i}.ln.scale", (d,), "one_plus_normal"),
                (f"blocks.{i}.mix.w", (d, d), "normal")]
        out += [] if tied else _shared_specs(cfg, f"blocks.{i}.")
    return out + [("final_norm.scale", (d,), "one_plus_normal")]


def _layer(cfg, m, p, h, prec, kv_out=None, *, h0):
    """The shared block on concat(h, h0), causal attention, then the layer's
    own norm and matrix."""
    b, s, d = h.shape
    x = prec.mm(torch.cat([h, h0], dim=-1), p["shared.in.w"])

    def heads(name):
        return prec.mm(x, p[f"shared.{name}.w"]).reshape(b, s, m["h"], m["dh"]).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    if kv_out is not None:
        kv_out[:] = [k, v]
    attn = lm.causal_attention(q, k, v, prec).transpose(1, 2).reshape(b, s, m["h"] * m["dh"])
    h = h + prec.mm(attn, p["shared.o.w"])
    return h + prec.mm(lm.rms_norm(h, p["ln.scale"], cfg["norm_epsilon"]), p["mix.w"])


def _final_norm(cfg, params, h):
    return lm.rms_norm(h, params["final_norm.scale"], cfg["norm_epsilon"])


def _family(name, tied):
    mod = types.ModuleType(f"chipbench.reference.{name}")
    mod.READS_H0 = True
    mod.dims, mod.layer, mod.final_norm = _dims, _layer, _final_norm
    mod.param_specs = lambda cfg: _specs(cfg, tied)
    if tied:
        mod.layer_params = lambda params, i: {**lm._layer_params(params, i),
                                              **{k: params[k] for k in SHARED}}
    return mod


@pytest.fixture
def toy(monkeypatch):
    """The shared-block family and its untied twin (each layer its own copy
    of the block, under ``blocks.{i}.shared.*``, by the default hook)."""
    tied, untied = _family("toy_shared", True), _family("toy_untied", False)
    monkeypatch.setitem(sys.modules, tied.__name__, tied)
    monkeypatch.setitem(sys.modules, untied.__name__, untied)
    return tied


def _weights(cfg=CFG, seed=3):
    return inputs.draw_weights(lm.param_specs(cfg), cfg, seed, "cpu", torch.float32)


def _untie(weights):
    out = {k: w for k, w in weights.items() if k not in SHARED}
    for i in range(2):
        out.update({f"blocks.{i}.{k}": weights[k].clone() for k in SHARED})
    return out


def _tokens(rows=2, cols=6, index=0):
    return inputs.tokens(3, index, rows, cols, CFG["vocab"], "cpu")


def _by_hand(params, toks, kv_at=None):
    """The toy model written out: both layers on the same shared tensors."""
    h0 = params["embed.table"][toks]
    h, kv = h0, []
    for i in range(2):
        own = {k[len(f"blocks.{i}."):]: w for k, w in params.items()
               if k.startswith(f"blocks.{i}.")}
        p = dict(own, **{k: params[k] for k in SHARED})
        h = _layer(CFG, _dims(CFG), p, h, F32, kv if i == kv_at else None, h0=h0)
    return _final_norm(CFG, params, h), kv


def test_the_shared_tensor_is_listed_and_drawn_once(toy):
    names = [n for n, _, _ in lm.param_specs(CFG)]
    assert len(names) == len(set(names))
    weights = _weights()
    assert set(weights) == set(names) and all(k in weights for k in SHARED)
    assert not any(".shared." in k for k in weights)


@torch.no_grad()
def test_hidden_is_the_loop_over_the_same_tensors(toy):
    params, toks = _weights(), _tokens()
    h, kv = lm.hidden(CFG, params, toks, F32)
    want, _ = _by_hand(params, toks)
    assert kv is None and torch.equal(h, want)


@torch.no_grad()
@pytest.mark.parametrize("kv_layer", [0, 1])
def test_kv_layer_gives_the_shared_calls_k_and_v(toy, kv_layer):
    params, toks = _weights(), _tokens()
    h, kv = lm.hidden(CFG, params, toks, F32, kv_layer=kv_layer)
    want_h, want_kv = _by_hand(params, toks, kv_at=kv_layer)
    assert torch.equal(h, want_h)
    assert len(kv) == 2 and all(torch.equal(a, b) for a, b in zip(kv, want_kv))
    # the two calls read different inputs through the same weights
    _, other = _by_hand(params, toks, kv_at=1 - kv_layer)
    assert not torch.equal(kv[0], other[0])


def test_the_first_gradient_of_a_shared_tensor_sums_its_uses(toy, monkeypatch):
    """``reference/train.run`` takes the loss's gradient (each layer
    recomputed in the backward); the shared tensor's is the sum of what
    the untied twin's two copies get on the same values."""
    seen = []
    compress = ref_train.compress_

    def record(grads, residuals):
        seen.append({k: g.clone() for k, g in grads.items()})
        compress(grads, residuals)

    monkeypatch.setattr(ref_train, "compress_", record)
    batch = [lambda: (_tokens(index=1), _tokens(index=2))]
    tied = ref_train.run(CFG, _weights, batch, OPT, F32)
    untied_cfg = dict(CFG, family="toy_untied")
    ref_train.run(untied_cfg, lambda: _untie(_weights()), batch, OPT, F32)
    (g_tied, g_untied) = seen
    for k in SHARED:
        uses = [g_untied[f"blocks.{i}.{k}"] for i in range(2)]
        assert not torch.equal(uses[0], uses[1]) and torch.linalg.vector_norm(uses[1]) > 0
        torch.testing.assert_close(g_tied[k], uses[0] + uses[1], rtol=1e-6, atol=1e-9)
    assert set(tied["grad_norms"]) == set(g_tied) and all(k in tied["grad_norms"] for k in SHARED)
    for k in set(g_tied) - set(SHARED):  # a tensor of one layer gets the same gradient either way
        torch.testing.assert_close(g_tied[k], g_untied[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("config, want", [("toy", 1), ("starcoder2-3b", 1), ("mamba2-130m", None)])
def test_last_kv_layer_is_the_last_layer_that_fills_kv_out(toy, config, want):
    cfg = CFG if config == "toy" else smoke.config(config)
    if want is None:
        with pytest.raises(ValueError, match=r"mamba2-130m.*mamba2 family fills kv_out"):
            lm.last_kv_layer(cfg)
    else:
        assert lm.last_kv_layer(cfg) == want


def test_the_prefill_control_of_a_shared_block_family(toy):
    """``calibrate`` reads the control's gaps at the last shared call; the
    fp8 products move both."""
    bench = spec.Spec(smoke.ROOT)
    control = calibrate.readings(bench, "starcoder2-3b.prefill_mix", 11, "cpu", 3, cfg=CFG,
                                 traffic=smoke.traffic(bench, "prefill_mix"))["control"]
    assert set(control) == {"token_gap", "kv_gap"} and 0 < control["kv_gap"] < 1, control
    with pytest.raises(ValueError, match="mamba2-130m.*kv_out"):
        calibrate.readings(bench, "starcoder2-3b.prefill_mix", 11, "cpu", 3,
                           cfg=smoke.config("mamba2-130m", torch_dtype="float32"),
                           traffic=smoke.traffic(bench, "prefill_mix"))


def _direct(cfg, params, toks, kv_at=None):
    """A family without hooks run as a loop over its ``blocks.{i}.`` slices."""
    fam = lm.family(cfg)
    m = fam.dims(cfg)
    h, kv = params["embed.table"][toks], []
    for i in range(m["layers"]):
        h = fam.layer(cfg, m, lm._layer_params(params, i), h, F32, kv if i == kv_at else None)
    return fam.final_norm(cfg, params, h), kv


@pytest.mark.parametrize("config", ["starcoder2-3b", "mamba2-130m"])
def test_families_without_hooks_run_as_before_bitwise(config):
    cfg = smoke.config(config, torch_dtype="float32")
    params = inputs.draw_weights(lm.param_specs(cfg), cfg, 5, "cpu", torch.float32)
    toks = inputs.tokens(5, 0, 2, 24, lm.dims(cfg)["vocab"], "cpu")
    labels = inputs.tokens(5, 1, 2, 24, lm.dims(cfg)["vocab"], "cpu")
    with torch.no_grad():
        want, want_kv = _direct(cfg, params, toks, kv_at=1)
        h, _ = lm.hidden(cfg, params, toks, F32)
        h_kv, kv = lm.hidden(cfg, params, toks, F32, kv_layer=1)
        flat = want.reshape(-1, want.shape[-1])
        want_loss = lm._nll_sum(flat, params["embed.table"], labels.reshape(-1), F32) \
            / labels.numel()
    assert torch.equal(h, want) and torch.equal(h_kv, want)
    assert len(kv) == len(want_kv) and all(torch.equal(a, b) for a, b in zip(kv, want_kv))
    grad_params = {k: w.clone().requires_grad_(True) for k, w in params.items()}
    loss = lm.loss(cfg, grad_params, toks, labels, F32)  # the training path: layers checkpointed
    assert torch.equal(loss.detach(), want_loss)


# ---------------------------------------------------------------------------
# the prefill entry's cache lookup
# ---------------------------------------------------------------------------


def _caches(n_layers, shared):
    """A hybrid model's caches: a Mamba2 state a layer, then the shared
    block's KV caches."""
    state = [{"conv": torch.zeros(1, 2), "ssm": torch.zeros(1, 2)} for _ in range(n_layers)]
    return state + [{"k": torch.full((1, 1, 3, 2), float(g)), "v": torch.full((1, 1, 3, 2), -g)}
                    for g in range(shared)]


def test_the_last_cache_of_a_hybrid_layout_is_the_trailing_shared_one():
    """The port keeps the shared block's caches after the layers', one a
    call: the last is the last call's, which the toy's ``last_kv_layer``
    (layer 1, its second call) is compared with."""
    k, v = port.last_kv(_caches(2, 2))
    assert float(k[0, 0, 0, 0]) == 1.0 and float(v[0, 0, 0, 0]) == -1.0


def test_a_layout_with_no_attention_cache_has_no_last_kv():
    assert port.last_kv(_caches(2, 0)) is None


def _context(cfg):
    bench = spec.Spec(smoke.ROOT)
    ctx = harness.Context(cfg, smoke.traffic(bench, "prefill_mix"), 11, 0.0, False, "cpu",
                          time.perf_counter())

    def started():
        raise AssertionError("the window started")

    ctx.mark_window_start = started
    return ctx


def test_a_prefill_of_a_model_with_no_attention_cache_stops_before_the_window():
    ctx = _context(smoke.config("mamba2-130m", torch_dtype="float32"))
    with pytest.raises(ValueError, match=r"mamba2-130m.*kv_out"):
        prefill.run(ctx)


def test_a_prefill_whose_port_caches_hold_no_keys_stops_before_the_window(monkeypatch):
    ctx = _context(smoke.config("starcoder2-3b", torch_dtype="float32"))
    monkeypatch.setattr(port, "last_kv", lambda caches: None)
    with pytest.raises(ValueError, match=r"starcoder2-3b.*port\.last_kv"):
        prefill.run(ctx)


@pytest.mark.parametrize("ref_layer, correct", [(None, True), (0, False)])
def test_the_prefill_entry_pairs_the_last_cache_with_last_kv_layer(monkeypatch, ref_layer,
                                                                   correct):
    """The port's last cache is judged against ``last_kv_layer``'s layer,
    the last of two: it passes there, and fails against the first layer."""
    judged = []
    hidden = lm.hidden

    def spy(*args, kv_layer=None):
        judged.append(kv_layer)
        return hidden(*args, kv_layer=kv_layer)

    if ref_layer is not None:
        monkeypatch.setattr(lm, "last_kv_layer", lambda cfg: ref_layer)
    monkeypatch.setattr(lm, "hidden", spy)
    result = smoke.run("starcoder2-3b.prefill_mix")
    assert judged and set(judged) == {1 if ref_layer is None else ref_layer}
    assert result["correct"] is correct
    assert (result["checks"]["kv_gap"]["value"] < 1e-5) is correct
