"""Decoder-only LM over a repeating pattern of block kinds, the reference's
``models/lm.py``, for the kinds the port carries:

    "attn"   -- global attention + dense FFN   (starcoder2, granite-20b, qwen1.5)
    "local"  -- sliding-window attention + FFN (gemma3's local layers; ring KV cache)
    "moe"    -- global attention + top-k MoE   (granite-moe, phi3.5-moe)
    "mamba"  -- Mamba2 SSD block               (mamba2, zamba2's backbone)

With ``shared_attn`` (zamba2) ONE attention + MLP block, ``LM.shared``, is
invoked once per group, before that group's pattern, on concat(h, h0):
``h0`` is the embedded input (the whole prompt in ``forward`` and
``prefill``, the current token in ``decode_step``). Its weights are one
copy, so its gradient sums over the ``n_groups`` calls.

``HybridLMConfig`` is Zamba2-7B's published layout of the same idea: at
each of ``hybrid_layers`` (call c) the layer first calls shared block
``c % n_shared_blocks`` (``LM.shared`` is then a list, ``SharedBlock``):
RMSNorm over concat(h, h0), attention 2d wide in and d out, RMSNorm, a
gated MLP whose gate-up projection adds the call's own low-rank adapter,
no residual inside. Its output goes through the layer's own d x d
``linear`` into the layer's Mamba2 input, h + Mamba2(norm(h + t)); the
per-call tensors live on the layer (``HybridBlock``). With ``vision``
(phi-3-vision) ``images``, precomputed patch embeddings (b, n_patches,
d_vision), go through ``LM.vision_proj`` and are prepended to the tokens.

Where the reference stacks each pattern position's weights over
``n_groups`` and runs ``lax.scan``, the port keeps one module per layer in
an ``nn.ModuleList``: layer ``g * len(pattern) + i`` is group g's block of
pattern position i. Caches are a list: ``caches[layer]`` is that layer's
dict, for every arch; with ``shared_attn`` one shared-attention KV cache a
call follows, ``caches[n_layers + c]`` call c's (group c's, or hybrid layer
``hybrid_layers[c]``'s). Each shared call runs inside an ``lm.shared`` span
(category ``model``, ``args`` call and block) and counts one
``lm.shared_calls``. Entry points:

    forward(cfg, model, tokens, images=None)       -> (logits, aux)
    loss_fn(cfg, model, batch)                     -> (loss, {ce, lb, z})
    prefill(cfg, model, tokens, max_cache_len=L, images=None)
                                                   -> (caches, last logits)
    decode_step(cfg, model, caches, token)         -> (caches, logits)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.models import attention, common, mamba2, moe
from repro_torch.models.attention import AttnConfig
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.parallel import context as pctx

PORTED_KINDS = ("attn", "local", "moe", "mamba")


@dataclasses.dataclass(frozen=True)
class VisionStub:
    n_patches: int
    d_vision: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    pattern: Tuple[str, ...]  # super-block; n_layers % len(pattern) == 0
    attn: Optional[AttnConfig] = None
    local_window: Optional[int] = None
    d_ff: int = 0
    mlp_gated: bool = True
    moe_cfg: Optional[MoEConfig] = None
    mamba_cfg: Optional[Mamba2Config] = None
    shared_attn: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = True
    scale_embeddings: bool = False
    dtype: Any = torch.bfloat16
    vision: Optional[VisionStub] = None
    remat: bool = True
    scan_nest: int = 1
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.n_layers} layers over pattern {self.pattern}")
        return self.n_layers // len(self.pattern)

    def local_attn(self) -> AttnConfig:
        return dataclasses.replace(self.attn, window=self.local_window)

    def kinds(self) -> List[str]:
        """The block kind of every layer, in order."""
        return [k for _ in range(self.n_groups) for k in self.pattern]

    # not fields: ``HybridLMConfig`` sets them, so the configs of the archs
    # keep the reference's fields
    hybrid_layers = ()
    n_shared_blocks = 1
    adapter_rank = 0


@dataclasses.dataclass(frozen=True)
class HybridLMConfig(LMConfig):
    """Zamba2-7B's published layout (``shared_attn``): the layers that call a
    shared block, the blocks called in turn, and the rank of each call's
    adapter on the gate-up projection."""

    hybrid_layers: Tuple[int, ...] = ()
    n_shared_blocks: int = 1
    adapter_rank: int = 0


def shared_calls(cfg: LMConfig) -> Dict[int, Tuple[int, int]]:
    """{layer: (call, block)} of the shared block's calls: before the first
    layer of every group, or at each of ``hybrid_layers``, block ``call %
    n_shared_blocks``."""
    if not cfg.shared_attn:
        return {}
    if cfg.hybrid_layers:
        return {layer: (c, c % cfg.n_shared_blocks) for c, layer in enumerate(cfg.hybrid_layers)}
    return {g * len(cfg.pattern): (g, 0) for g in range(cfg.n_groups)}


def _check_kinds(cfg: LMConfig) -> None:
    bad = [k for k in cfg.pattern if k not in PORTED_KINDS]
    if bad:
        raise ValueError(f"block kind {bad[0]!r}")
    kinds = cfg.kinds()
    if any(not 0 <= i < len(kinds) or kinds[i] != "mamba" for i in cfg.hybrid_layers):
        raise ValueError(f"hybrid layers {cfg.hybrid_layers} must be Mamba2 layers")


def _attn_cfg(cfg: LMConfig, kind: str) -> AttnConfig:
    return cfg.local_attn() if kind == "local" else cfg.attn


class AttnBlock(nn.Module):
    """ln1 -> attention -> residual, ln2 -> MLP (or, for "moe", the
    mixture of experts) -> residual."""

    def __init__(self, cfg: LMConfig, kind: str, *, generator: torch.Generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        self.ln1 = common.Norm(d, kind=cfg.norm, dtype=dt, device=device)
        self.attn = attention.init(_attn_cfg(cfg, kind), dt, generator=generator,
                                   device=device)
        self.ln2 = common.Norm(d, kind=cfg.norm, dtype=dt, device=device)
        if kind == "moe":
            self.moe = moe.init(cfg.moe_cfg, dt, generator=generator, device=device)
        else:
            self.mlp = common.MLP(d, cfg.d_ff, gated=cfg.mlp_gated, bias=False,
                                  act=cfg.act, dtype=dt, generator=generator, device=device)


class MambaBlock(nn.Module):
    """ln -> Mamba2 -> residual."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator, device):
        super().__init__()
        self.ln = common.Norm(cfg.d_model, kind=cfg.norm, dtype=cfg.dtype, device=device)
        self.mamba = mamba2.init(cfg.mamba_cfg, cfg.dtype, generator=generator,
                                 device=device)


class Shared(nn.Module):
    """zamba2's shared block: in_proj (2d -> d) of concat(h, h0), then
    ln1 -> attention -> residual, ln2 -> MLP -> residual."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        kw = dict(dtype=dt, generator=generator, device=device)
        self.in_proj = common.Linear(2 * d, d, bias=False, **kw)
        self.ln1 = common.Norm(d, kind=cfg.norm, dtype=dt, device=device)
        self.attn = attention.init(cfg.attn, dt, generator=generator, device=device)
        self.ln2 = common.Norm(d, kind=cfg.norm, dtype=dt, device=device)
        self.mlp = common.MLP(d, cfg.d_ff, gated=cfg.mlp_gated, bias=False, act=cfg.act,
                              **kw)


class SharedBlock(nn.Module):
    """One of Zamba2-7B's shared blocks: ln1 (2d) -> attention (2d in, d
    out) -> ln2 -> gated MLP with the gate and up projections as one
    matrix (gate first), no residuals."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        kw = dict(bias=False, dtype=dt, generator=generator, device=device)
        self.ln1 = common.Norm(2 * d, kind=cfg.norm, dtype=dt, device=device)
        self.attn = attention.init(cfg.attn, dt, generator=generator, device=device)
        self.ln2 = common.Norm(d, kind=cfg.norm, dtype=dt, device=device)
        self.gate_up = common.Linear(d, 2 * cfg.d_ff, **kw)
        self.down = common.Linear(cfg.d_ff, d, **kw)


class HybridBlock(MambaBlock):
    """A Mamba2 layer that calls a shared block, with the call's own
    tensors: the adapter (d -> rank -> 2 d_ff) added to the gate-up
    projection, and the linear (d -> d) of the block's output."""

    def __init__(self, cfg: LMConfig, *, generator: torch.Generator, device):
        super().__init__(cfg, generator=generator, device=device)
        d = cfg.d_model
        kw = dict(bias=False, dtype=cfg.dtype, generator=generator, device=device)
        self.adapter_in = common.Linear(d, cfg.adapter_rank, **kw)
        self.adapter_out = common.Linear(cfg.adapter_rank, 2 * cfg.d_ff, **kw)
        self.linear = common.Linear(d, d, **kw)


class LM(nn.Module):
    def __init__(self, cfg: LMConfig, *, generator: torch.Generator, device):
        super().__init__()
        _check_kinds(cfg)
        kw = dict(dtype=cfg.dtype, generator=generator, device=device)
        self.embed = common.Embed(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(
            HybridBlock(cfg, generator=generator, device=device) if i in cfg.hybrid_layers
            else MambaBlock(cfg, generator=generator, device=device) if kind == "mamba"
            else AttnBlock(cfg, kind, generator=generator, device=device)
            for i, kind in enumerate(cfg.kinds()))
        if cfg.shared_attn and cfg.hybrid_layers:
            self.shared = nn.ModuleList(SharedBlock(cfg, generator=generator, device=device)
                                        for _ in range(cfg.n_shared_blocks))
        else:
            self.shared = (Shared(cfg, generator=generator, device=device) if cfg.shared_attn
                           else None)
        self.final_norm = common.Norm(cfg.d_model, kind=cfg.norm, dtype=cfg.dtype,
                                      device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        common.Linear(cfg.d_model, cfg.vocab, bias=False, **kw))
        self.vision_proj = (None if cfg.vision is None else
                            common.Linear(cfg.vision.d_vision, cfg.d_model, bias=False, **kw))


def init(cfg: LMConfig, *, generator: torch.Generator, device) -> LM:
    """Random weights from ``generator`` (on ``device``), the reference's
    init scheme; the numbers differ from ``jax.random``'s."""
    return LM(cfg, generator=generator, device=device)


def _ffn(blk, cfg: LMConfig, kind: str, z):
    """The block's FFN on z: (y, the MoE's aux dict or None)."""
    if kind == "moe":
        return moe.forward(blk.moe, cfg.moe_cfg, z)
    return blk.mlp(z), None


def _mamba_input(blk, h, t):
    """The Mamba2 input of a layer: norm(h), or norm(h + t) where a shared
    block's output t goes into it."""
    return blk.ln(h if t is None else h + t)


def _block_forward(blk, cfg: LMConfig, kind: str, h, positions, t=None, *, impl):
    """(h, the MoE's aux dict or None)."""
    blk = pctx.constrain_group_params(blk)
    if kind == "mamba":
        return h + mamba2.forward(blk.mamba, cfg.mamba_cfg, _mamba_input(blk, h, t),
                                  impl=impl), None
    h = h + attention.forward(blk.attn, _attn_cfg(cfg, kind), blk.ln1(h),
                              positions=positions, impl=impl)
    y, aux = _ffn(blk, cfg, kind, blk.ln2(h))
    return h + y, aux


def _block_prefill(blk, cfg: LMConfig, kind: str, h, positions, max_len, t=None, *, impl):
    blk = pctx.constrain_group_params(blk)
    if kind == "mamba":
        y, state = mamba2.forward(blk.mamba, cfg.mamba_cfg, _mamba_input(blk, h, t),
                                  return_state=True, impl=impl)
        return h + y, state
    a, cache = attention.forward(blk.attn, _attn_cfg(cfg, kind), blk.ln1(h),
                                 positions=positions, return_cache=True,
                                 max_cache_len=max_len, impl=impl)
    h = h + a
    return h + _ffn(blk, cfg, kind, blk.ln2(h))[0], cache


def _block_decode(blk, cfg: LMConfig, kind: str, h, cache, t=None, *, impl):
    blk = pctx.constrain_group_params(blk)
    if kind == "mamba":
        y, cache = mamba2.decode_step(blk.mamba, cfg.mamba_cfg, _mamba_input(blk, h, t), cache)
        return h + y, cache
    a, cache = attention.decode_step(blk.attn, _attn_cfg(cfg, kind), blk.ln1(h), cache,
                                     impl=impl)
    h = h + a
    return h + _ffn(blk, cfg, kind, blk.ln2(h))[0], cache


def _shared_forward(p: Shared, cfg: LMConfig, h, h0, positions, *, impl):
    """The shared block on concat(h, h0): its contribution, which the
    caller adds to the trunk (the reference's ``_shared_forward``)."""
    x = p.in_proj(torch.cat([h, h0], dim=-1))
    x = x + attention.forward(p.attn, cfg.attn, p.ln1(x), positions=positions, impl=impl)
    return x + p.mlp(p.ln2(x))


def _shared_prefill(p: Shared, cfg: LMConfig, h, h0, positions, max_len, *, impl):
    x = p.in_proj(torch.cat([h, h0], dim=-1))
    a, cache = attention.forward(p.attn, cfg.attn, p.ln1(x), positions=positions,
                                 return_cache=True, max_cache_len=max_len, impl=impl)
    x = x + a
    return x + p.mlp(p.ln2(x)), cache


def _shared_decode(p: Shared, cfg: LMConfig, h, h0, cache, *, impl):
    x = p.in_proj(torch.cat([h, h0], dim=-1))
    a, cache = attention.decode_step(p.attn, cfg.attn, p.ln1(x), cache, impl=impl)
    x = x + a
    return x + p.mlp(p.ln2(x)), cache


def _hybrid_block(p: SharedBlock, blk: HybridBlock, cfg: LMConfig, h, h0, positions,
                  cache=None, max_len=None, *, impl):
    """A published shared block's call: ln1 over concat(h, h0), attention
    (forward; prefill with ``max_len``; a decode step on ``cache``), ln2,
    the gate-up projection plus the call's adapter, the gated MLP, then
    the hybrid layer's linear. (What it adds to the layer's Mamba2 input,
    the call's cache or None)."""
    x = p.ln1(torch.cat([h, h0], dim=-1))
    if cache is not None:
        a, cache = attention.decode_step(p.attn, cfg.attn, x, cache, impl=impl)
    elif max_len is not None:
        a, cache = attention.forward(p.attn, cfg.attn, x, positions=positions,
                                     return_cache=True, max_cache_len=max_len, impl=impl)
    else:
        a = attention.forward(p.attn, cfg.attn, x, positions=positions, impl=impl)
    y = p.ln2(a)
    gate, up = (p.gate_up(y) + blk.adapter_out(blk.adapter_in(y))).split(cfg.d_ff, dim=-1)
    return blk.linear(p.down(common.activation(cfg.act)(gate) * up)), cache


def _shared_call(cfg: LMConfig, model: LM, blk, call: Tuple[int, int], h, h0, positions,
                 cache=None, max_len=None, *, impl, run=None):
    """Shared-block call ``call`` = (c, j) before layer ``blk``, inside its
    ``lm.shared`` span: forward, prefill (``max_len``) or a decode step
    (``cache``). Returns (h, t, the call's cache or None): the JAX-parity
    block adds its output to h (t None); a published block leaves h and
    returns t for the layer's Mamba2 input. ``run(fn, *args)`` calls a
    forward (``forward``'s recomputing wrapper)."""
    c, j = call
    run = run or (lambda fn, *args: fn(*args, impl=impl))
    with _shared_span(c, j):
        if cfg.hybrid_layers:
            t, cache = run(_hybrid_block, model.shared[j], blk, cfg, h, h0, positions, cache,
                           max_len)
            return h, t, cache
        if cache is not None:
            y, cache = _shared_decode(model.shared, cfg, h, h0, cache, impl=impl)
        elif max_len is not None:
            y, cache = _shared_prefill(model.shared, cfg, h, h0, positions, max_len, impl=impl)
        else:
            y = run(_shared_forward, model.shared, cfg, h, h0, positions)
        return h + y, None, cache


def _shared_span(call: int, block: int):
    """The span of one shared-block call, counted in ``lm.shared_calls``."""
    obs.counter("lm.shared_calls").inc()
    return obs.span("lm.shared", cat="model", call=call, block=block)


def _embed_inputs(cfg: LMConfig, model: LM, tokens: torch.Tensor,
                  images: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, with a VLM's projected image patches prepended."""
    h = model.embed(tokens)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype, device=h.device)
    if cfg.vision is not None and images is not None:
        img = model.vision_proj(images.to(cfg.dtype))
        h = torch.cat([img, h], dim=1)
    return h


def _logits(cfg: LMConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    h = model.final_norm(h)
    if cfg.tie_embeddings:
        return common.unembed(model.embed, h)
    return common.linear_f32out(model.lm_head, h)


def forward(cfg: LMConfig, model: LM, tokens: torch.Tensor, images=None, *,
            impl: Optional[str] = None):
    """tokens (b, s) [, images (b, n_patches, d_vision)] -> (logits (b,
    s_total, vocab) f32, aux losses {lb, z}); s_total counts the patches.

    With ``cfg.remat`` and grad mode on, every layer (and every call of
    the shared block) is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant): only each one's input is
    kept, as the reference's per-group ``jax.checkpoint``. The reference's
    ``scan_nest`` (a second level of recomputation that keeps fewer of
    those inputs) changes memory only; the port keeps one input a layer
    for every config.
    """
    h = pctx.constrain(_embed_inputs(cfg, model, tokens, images))
    h0 = h
    positions = torch.arange(h.shape[1], device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def call(fn, *args):
        if remat:
            return checkpoint(fn, *args, impl=impl, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args, impl=impl)

    lb = z = torch.zeros((), dtype=torch.float32, device=h.device)
    calls = shared_calls(cfg)
    for layer, (blk, kind) in enumerate(zip(model.blocks, cfg.kinds())):
        t = None
        if layer in calls:
            h, t, _ = _shared_call(cfg, model, blk, calls[layer], h, h0, positions, impl=impl,
                                   run=call)
        h, moe_aux = call(_block_forward, blk, cfg, kind, h, positions, t)
        if moe_aux is not None:  # summed in layer order, as the reference's scan carry
            lb = lb + moe_aux["load_balance_loss"]
            z = z + moe_aux["router_z_loss"]
        if (layer + 1) % len(cfg.pattern) == 0:  # a group's end
            h = pctx.constrain(h)
    return _logits(cfg, model, h), {"lb": lb, "z": z}


def loss_fn(cfg: LMConfig, model: LM, batch, *, impl: Optional[str] = None):
    """batch {tokens (b, s), labels (b, s), [mask], [images]} -> (loss,
    {ce, lb, z}), the reference's ``loss_fn``: cross-entropy (on the text
    positions only when images are prepended) plus the MoE layers' summed
    load-balance and router z-losses, weighted by ``cfg.moe_aux_weight``
    and ``cfg.moe_z_weight`` (zero without MoE layers)."""
    images = batch.get("images")
    logits, aux = forward(cfg, model, batch["tokens"], images, impl=impl)
    if cfg.vision is not None and images is not None:
        logits = logits[:, -batch["tokens"].shape[1]:]
    loss = common.cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + cfg.moe_aux_weight * aux["lb"] + cfg.moe_z_weight * aux["z"]
    return total, {"ce": loss, **aux}


def _has_global_attention(cfg: LMConfig) -> bool:
    return cfg.shared_attn or any(kind != "mamba" and _attn_cfg(cfg, kind).window is None
                                  for kind in cfg.pattern)


def prefill(cfg: LMConfig, model: LM, tokens: torch.Tensor, *, max_cache_len: int,
            images=None, impl: Optional[str] = None):
    """Build decode caches from a full prompt (image patches first, for a
    VLM given ``images``): (caches, logits of the last position (b, 1,
    vocab) f32).

    A global-attention cache must hold the whole sequence: a longer one
    raises ``ValueError`` where it would otherwise become a ring, which
    only a sliding-window layer can decode from (a VLM's sequence is
    n_patches + prompt)."""
    h = _embed_inputs(cfg, model, tokens, images)
    s = h.shape[1]
    if s > max_cache_len and _has_global_attention(cfg):
        parts = (f" ({s - tokens.shape[1]} image patches + {tokens.shape[1]} tokens)"
                 if s != tokens.shape[1] else "")
        raise ValueError(f"{cfg.name}: prefill of {s} positions{parts} into a cache of "
                         f"{max_cache_len} slots; a global-attention cache must hold the "
                         f"whole sequence")
    h0 = h
    positions = torch.arange(s, device=h.device)
    caches, shared = [], []
    calls = shared_calls(cfg)
    for layer, (blk, kind) in enumerate(zip(model.blocks, cfg.kinds())):
        t = None
        if layer in calls:
            h, t, cache = _shared_call(cfg, model, blk, calls[layer], h, h0, positions,
                                       max_len=max_cache_len, impl=impl)
            shared.append(cache)
        h, cache = _block_prefill(blk, cfg, kind, h, positions, max_cache_len, t, impl=impl)
        caches.append(cache)
    return caches + shared, _logits(cfg, model, h[:, -1:, :])


def init_caches(cfg: LMConfig, batch: int, max_len: int, device) -> list:
    """Zero caches for decode from scratch, in ``prefill``'s layout."""
    _check_kinds(cfg)
    layers = [mamba2.make_state(cfg.mamba_cfg, batch, cfg.dtype, device) if kind == "mamba"
              else attention.make_cache(_attn_cfg(cfg, kind), batch, max_len, cfg.dtype,
                                        device)
              for kind in cfg.kinds()]
    shared = [attention.make_cache(cfg.attn, batch, max_len, cfg.dtype, device)
              for _ in shared_calls(cfg)]
    return layers + shared


def set_cache_position(caches, idx: int):
    """Caches marked as holding ``idx`` valid tokens (the dry run's decode
    at position ``idx``): the same tree, with every ``idx`` entry set to
    ``idx`` and the tensors shared, not copied."""
    if isinstance(caches, dict):
        return {k: idx if k == "idx" else set_cache_position(v, idx)
                for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(set_cache_position(c, idx) for c in caches)
    return caches


def decode_step(cfg: LMConfig, model: LM, caches: list, token: torch.Tensor, *,
                impl: Optional[str] = None):
    """token (b, 1) -> (new caches, logits (b, 1, vocab) f32). Attention
    caches (the shared block's too) are updated in place
    (``attention.decode_step``)."""
    h = _embed_inputs(cfg, model, token)
    h0 = h
    n_layers = len(model.blocks)
    layers, shared = [], []
    calls = shared_calls(cfg)
    for layer, (blk, kind) in enumerate(zip(model.blocks, cfg.kinds())):
        t = None
        if layer in calls:
            h, t, cache = _shared_call(cfg, model, blk, calls[layer], h, h0, None,
                                       caches[n_layers + calls[layer][0]], impl=impl)
            shared.append(cache)
        h, cache = _block_decode(blk, cfg, kind, h, caches[layer], t, impl=impl)
        layers.append(cache)
    return layers + shared, _logits(cfg, model, h)
