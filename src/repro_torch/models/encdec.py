"""Whisper-style encoder-decoder backbone (the audio arch, its frontend
stubbed), the reference's ``models/encdec.py``.

The conv/mel frontend is a stub: ``frames`` are precomputed frame
embeddings (b, n_frames, d_model) that go straight into the encoder
(bidirectional attention, sinusoidal positions). The decoder is a causal
stack with cross-attention into the encoder's output and learned
positional embeddings (whisper's layout). No attention uses RoPE.

The modules carry the reference's parameter names (``enc_blocks``,
``dec_blocks`` with ``self``, ``ln_x``, ``cross``, ``tok_embed``,
``pos_embed``, ``enc_final``, ``dec_final``), one module a layer where the
reference stacks each leaf over layers. Caches are a list with one dict a
decoder layer, ``{"self": KV cache of max_len slots, "cross": KV cache of
the encoder's n_frames}`` (``attention.make_cache``); ``decode_step``
writes the self-attention caches in place and reads the cross caches.
Entry points:

    forward(cfg, model, frames, tokens)               -> logits
    loss_fn(cfg, model, batch)                        -> (loss, {})
    prefill(cfg, model, frames, tokens, max_cache_len=L)
                                                      -> (caches, last logits)
    init_caches(cfg, batch, max_len, enc_len, device) -> caches
    decode_step(cfg, model, caches, token)            -> (caches, logits)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, common
from repro_torch.models.attention import AttnConfig
from repro_torch.parallel import context as pctx


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    vocab: int
    d_model: int
    n_enc_layers: int
    n_dec_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    max_target_len: int = 448
    norm: str = "layernorm"
    act: str = "gelu"
    dtype: Any = torch.bfloat16
    remat: bool = True

    def enc_attn(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                          n_kv_heads=self.n_kv_heads, d_head=self.d_head, causal=False,
                          use_rope=False)

    def dec_self_attn(self) -> AttnConfig:
        return dataclasses.replace(self.enc_attn(), causal=True)

    def cross_attn(self) -> AttnConfig:
        return self.enc_attn()


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    """(n, d) f32: [sin | cos] of pos / 10000^(2 i / d), the reference's
    expression in f32. The power is taken in f64 and rounded once to f32:
    that is XLA's f32 ``10000.0 ** x`` bit for bit at whisper-medium's 512
    exponents, where torch's f32 ``pow`` is one ulp off at 4 of them (and an
    angle near position 1,500 would then move by ~1e-4). The division is
    exact-rounded on both sides; f32 ``sin`` and ``cos`` differ from XLA's
    by at most one ulp."""
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    denom = (10000.0 ** (2 * dim / d).double()).float()
    ang = pos / denom
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(cfg: EncDecConfig, device) -> common.Norm:
    return common.Norm(cfg.d_model, kind=cfg.norm, dtype=cfg.dtype, device=device)


def _mlp(cfg: EncDecConfig, generator, device) -> common.MLP:
    return common.MLP(cfg.d_model, cfg.d_ff, gated=False, bias=True, act=cfg.act,
                      dtype=cfg.dtype, generator=generator, device=device)


class EncBlock(nn.Module):
    """ln1 -> bidirectional attention -> residual, ln2 -> MLP -> residual."""

    def __init__(self, cfg: EncDecConfig, *, generator: torch.Generator, device):
        super().__init__()
        self.ln1 = _norm(cfg, device)
        self.attn = attention.init(cfg.enc_attn(), cfg.dtype, generator=generator,
                                   device=device)
        self.ln2 = _norm(cfg, device)
        self.mlp = _mlp(cfg, generator, device)


class DecBlock(nn.Module):
    """ln1 -> causal self-attention, ln_x -> cross-attention into the
    encoder's output, ln2 -> MLP; each with a residual."""

    def __init__(self, cfg: EncDecConfig, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = _norm(cfg, device)
        self.self = attention.init(cfg.dec_self_attn(), cfg.dtype, **kw)
        self.ln_x = _norm(cfg, device)
        self.cross = attention.init(cfg.cross_attn(), cfg.dtype, **kw)
        self.ln2 = _norm(cfg, device)
        self.mlp = _mlp(cfg, generator, device)


class EncDec(nn.Module):
    def __init__(self, cfg: EncDecConfig, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, **kw) for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.n_dec_layers))
        self.tok_embed = common.Embed(cfg.vocab, cfg.d_model, dtype=cfg.dtype, **kw)
        self.pos_embed = common.Embed(cfg.max_target_len, cfg.d_model, dtype=cfg.dtype, **kw)
        self.enc_final = _norm(cfg, device)
        self.dec_final = _norm(cfg, device)


def init(cfg: EncDecConfig, *, generator: torch.Generator, device) -> EncDec:
    """Random weights from ``generator`` (on ``device``), the reference's
    init scheme; the numbers differ from ``jax.random``'s."""
    return EncDec(cfg, generator=generator, device=device)


def _call(remat: bool, fn, *args, impl):
    """``fn(*args)``, recomputed in the backward when ``remat`` (one block's
    input kept, as the reference's per-layer ``jax.checkpoint``)."""
    if remat:
        return checkpoint(fn, *args, impl=impl, use_reentrant=False, preserve_rng_state=False)
    return fn(*args, impl=impl)


def _enc_block(blk: EncBlock, cfg: EncDecConfig, h, *, impl):
    h = h + attention.forward(blk.attn, cfg.enc_attn(), blk.ln1(h), impl=impl)
    return pctx.constrain(h + blk.mlp(blk.ln2(h)))


def encode(cfg: EncDecConfig, model: EncDec, frames: torch.Tensor, *,
           impl: Optional[str] = None) -> torch.Tensor:
    """frames (b, n_frames, d_model), precomputed frame embeddings (the
    stub) -> the encoder's output (b, n_frames, d_model)."""
    h = (frames.to(cfg.dtype)
         + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype))
    h = pctx.constrain(h)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.enc_blocks:
        h = _call(remat, _enc_block, blk, cfg, h, impl=impl)
    return model.enc_final(h)


def _dec_block(blk: DecBlock, cfg: EncDecConfig, h, enc_out, positions, *, impl):
    h = h + attention.forward(blk.self, cfg.dec_self_attn(), blk.ln1(h), positions=positions,
                              impl=impl)
    h = h + attention.forward(blk.cross, cfg.cross_attn(), blk.ln_x(h), kv_input=enc_out,
                              impl=impl)
    return h + blk.mlp(blk.ln2(h))


def _decode_stack(cfg: EncDecConfig, model: EncDec, h, enc_out, positions, *,
                  impl: Optional[str] = None):
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in model.dec_blocks:
        h = _call(remat, _dec_block, blk, cfg, h, enc_out, positions, impl=impl)
    return h


def _embed_tokens(cfg: EncDecConfig, model: EncDec, tokens: torch.Tensor, positions):
    return model.tok_embed(tokens) + model.pos_embed(positions % cfg.max_target_len)


def forward(cfg: EncDecConfig, model: EncDec, frames: torch.Tensor, tokens: torch.Tensor, *,
            impl: Optional[str] = None) -> torch.Tensor:
    """Teacher-forced forward -> logits (b, s_tok, vocab) f32."""
    enc_out = encode(cfg, model, frames, impl=impl)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = _decode_stack(cfg, model, _embed_tokens(cfg, model, tokens, pos), enc_out, pos,
                      impl=impl)
    return common.unembed(model.tok_embed, model.dec_final(h))


def loss_fn(cfg: EncDecConfig, model: EncDec, batch, *, impl: Optional[str] = None):
    """batch {frames, tokens, labels, [mask]} -> (cross-entropy, {})."""
    logits = forward(cfg, model, batch["frames"], batch["tokens"], impl=impl)
    return common.cross_entropy(logits, batch["labels"], batch.get("mask")), {}


def prefill(cfg: EncDecConfig, model: EncDec, frames: torch.Tensor, tokens: torch.Tensor, *,
            max_cache_len: int, impl: Optional[str] = None):
    """Encode, then a teacher-forced pass over the prompt that builds the
    decode caches: (caches, logits of the last position (b, 1, vocab) f32)."""
    enc_out = encode(cfg, model, frames, impl=impl)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = _embed_tokens(cfg, model, tokens, pos)
    caches = []
    for blk in model.dec_blocks:
        a, self_cache = attention.forward(blk.self, cfg.dec_self_attn(), blk.ln1(h),
                                          positions=pos, return_cache=True,
                                          max_cache_len=max_cache_len, impl=impl)
        h = h + a
        x, cross_cache = attention.forward(blk.cross, cfg.cross_attn(), blk.ln_x(h),
                                           kv_input=enc_out, return_cache=True, impl=impl)
        h = h + x
        h = h + blk.mlp(blk.ln2(h))
        caches.append({"self": self_cache, "cross": cross_cache})
    return caches, common.unembed(model.tok_embed, model.dec_final(h[:, -1:, :]))


def init_caches(cfg: EncDecConfig, batch: int, max_len: int, enc_len: int, device) -> list:
    """Zero caches for decode from scratch: a self cache of ``max_len``
    slots and a cross cache of ``enc_len`` a decoder layer."""
    return [{"self": attention.make_cache(cfg.dec_self_attn(), batch, max_len, cfg.dtype,
                                          device),
             "cross": attention.make_cache(cfg.cross_attn(), batch, enc_len, cfg.dtype,
                                           device)}
            for _ in range(cfg.n_dec_layers)]


def decode_step(cfg: EncDecConfig, model: EncDec, caches: list, token: torch.Tensor, *,
                impl: Optional[str] = None):
    """token (b, 1) -> (caches, logits (b, 1, vocab) f32). The position is
    the self caches' fill (the same in every layer), modulo
    ``max_target_len`` as in the reference; the cross-attention reads the
    encoder's keys and values from the caches."""
    idx = int(caches[0]["self"]["idx"])
    pos = torch.full((1,), idx % cfg.max_target_len, dtype=torch.long, device=token.device)
    h = model.tok_embed(token) + model.pos_embed(pos)
    new_caches = []
    for blk, cache in zip(model.dec_blocks, caches):
        a, self_cache = attention.decode_step(blk.self, cfg.dec_self_attn(), blk.ln1(h),
                                              cache["self"], impl=impl)
        h = h + a
        h = h + attention.cross_decode_step(blk.cross, cfg.cross_attn(), blk.ln_x(h),
                                            cache["cross"], impl=impl)
        h = h + blk.mlp(blk.ln2(h))
        new_caches.append({"self": self_cache, "cross": cache["cross"]})
    return new_caches, common.unembed(model.tok_embed, model.dec_final(h))
