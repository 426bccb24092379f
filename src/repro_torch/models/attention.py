"""GQA multi-head attention block with KV-cache decode paths, the
reference's ``models/attention.py``.

Self-attention supports grouped-query heads (MQA included), RoPE, optional
QKV biases, causal / bidirectional / sliding-window masks, prefill that
returns a KV cache, and one-token decode into the cache; cross-attention
reuses the projections with an externally supplied KV pair. The inner
product goes through ``kernels.ops.flash_attention``: the Hopper kernel on
the card for prefill and decode alike, the plain chunked version on the
host.

A cache is ``{"k": (b, hk, L, d), "v": ..., "idx": int}``. ``idx`` is a
Python int (the host knows every step's position, so the kernel gets it as
a launch argument). ``decode_step`` writes the new key and value into the
cache tensors in place, where the reference returns updated copies: a
serving step then moves one row per layer, not the whole cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.parallel import context as pctx


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 1e4
    qkv_bias: bool = False
    causal: bool = True
    window: Optional[int] = None  # sliding-window size (None = global)
    use_rope: bool = True

    # not fields: ``WideAttnConfig`` sets them, so the configs of the archs
    # keep the reference's fields
    d_in = None  # input width, d_model when None
    scale = None  # softmax scale, 1/sqrt(d_head) when None


@dataclasses.dataclass(frozen=True)
class WideAttnConfig(AttnConfig):
    """Attention that reads a wider input than it writes (Zamba2-7B's shared
    block: q, k, v of concat(h, h0), 2 d_model wide, o back to d_model),
    with a softmax scale of its own."""

    d_in: Optional[int] = None
    scale: Optional[float] = None


class Attention(nn.Module):
    """q, k, v, o projections; the functions below apply them."""

    def __init__(self, cfg: AttnConfig, dtype, *, generator: torch.Generator, device):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        hd, d_in = cfg.d_head, cfg.d_in or cfg.d_model
        self.q = common.Linear(d_in, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.k = common.Linear(d_in, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.v = common.Linear(d_in, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.o = common.Linear(cfg.n_heads * hd, cfg.d_model, bias=False, **kw)


def init(cfg: AttnConfig, dtype, *, generator: torch.Generator, device) -> Attention:
    return Attention(cfg, dtype, generator=generator, device=device)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    if pctx.is_dtensor(x):
        x = _whole_heads(x, n)
    b, s, _ = x.shape
    return x.reshape(b, s, n, d).transpose(1, 2)  # (b, h, s, d)


def cuts_heads(n: int, places, mesh, dim: int) -> bool:
    """Whether ``places`` on ``mesh`` split tensor dim ``dim``, which holds
    ``n`` heads' features, finer than whole heads."""
    sizes = tuple(mesh.shape)
    return n % math.prod(sizes[i] for i, place in enumerate(places) if place.is_shard(dim)) != 0


def _whole_heads(x, n: int):
    """x (b, s, n * d), a DTensor, its last dim split only as far as whole
    heads go. The rules shard by the full config's head counts, so a
    split that cuts a head arises only on a narrower config's weights
    (``tests/test_torch_sharding.py`` holds that it never does at full
    width); it is gathered first."""
    from torch.distributed.tensor import Replicate

    if not cuts_heads(n, x.placements, x.device_mesh, x.ndim - 1):
        return x
    places = [Replicate() if place.is_shard(x.ndim - 1) else place for place in x.placements]
    return x.redistribute(x.device_mesh, places)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def cache_len(cfg: AttnConfig, max_len: int) -> int:
    """Sliding-window layers keep a ring cache of ``window`` slots."""
    if cfg.window is not None:
        return min(max_len, cfg.window)
    return max_len


def make_cache(cfg: AttnConfig, batch: int, max_len: int, dtype, device) -> dict:
    """Preallocated KV cache (ring-sized for windowed layers)."""
    shape = (batch, cfg.n_kv_heads, cache_len(cfg, max_len), cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "idx": 0,
    }


def _flash(q, k, v, **kw):
    """``ops.flash_attention``; on DTensors each rank runs it (the kernel,
    or its plain version on the host) on its own shard: its batch rows and
    query heads, or query positions, with the keys and values those need.
    q's placements stay; k and v are redistributed to whole sequences, and
    to q's heads where they are not split with them."""
    if not pctx.is_dtensor(q):
        return ops.flash_attention(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    qp = [place if place.is_shard() else Replicate() for place in q.placements]
    q = q.redistribute(mesh, qp)  # a partial sum is reduced first
    h, hk = q.shape[1], k.shape[1]
    head_dims = [i for i, place in enumerate(qp) if place.is_shard(1)]
    # k and v keep a head split that gives each rank its query heads' groups
    kv_split = (all(k.placements[i].is_shard(1) for i in head_dims)
                and hk % math.prod(mesh.size(i) for i in head_dims) == 0)
    kvp = [Shard(0) if place.is_shard(0) else
           Shard(1) if place.is_shard(1) and kv_split else
           Replicate() for place in qp]
    lo_h, h_l = pctx.local_range(h, mesh, qp, 1)
    lo_s, _ = pctx.local_range(q.shape[2], mesh, qp, 2)
    # k and v whole over a mesh dim that splits q take gradient from this
    # rank's queries only: a partial sum over that dim
    kvg = [Partial() if kp.is_replicate() and p.is_shard() else kp for kp, p in zip(kvp, qp)]
    kl = k.redistribute(mesh, kvp).to_local(grad_placements=kvg)
    vl = v.redistribute(mesh, kvp).to_local(grad_placements=kvg)
    if head_dims and not kv_split:  # kv whole: this rank's query heads' own
        idx = torch.arange(lo_h, lo_h + h_l, device=kl.device) // (h // hk)
        kl, vl = kl[:, idx], vl[:, idx]
    kw = {**kw, "q_offset": kw.get("q_offset", 0) + lo_s}
    out = ops.flash_attention(q.to_local(), kl, vl, **kw)
    return DTensor.from_local(out, mesh, qp)


def forward(p: Attention, cfg: AttnConfig, x: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None, return_cache: bool = False,
            max_cache_len: Optional[int] = None,
            kv_input: Optional[torch.Tensor] = None, impl: Optional[str] = None):
    """Full-sequence attention (prefill / encoder / cross); x (b, s, d_model)."""
    b, s, _ = x.shape
    kv_src = x if kv_input is None else kv_input
    s_kv = kv_src.shape[1]
    q = _split_heads(p.q(x), cfg.n_heads, cfg.d_head)
    k = _split_heads(p.k(kv_src), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(p.v(kv_src), cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope and kv_input is None:
        pos = torch.arange(s, device=x.device) if positions is None else positions
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    out = _flash(q, k, v, causal=cfg.causal and kv_input is None, window=cfg.window,
                 scale=cfg.scale, impl=impl)
    out = p.o(_merge_heads(out))
    if not return_cache:
        return out
    if pctx.is_dtensor(k):
        return out, _placed_cache(k, v, cache_len(cfg, max_cache_len or s_kv))
    cache = make_cache(cfg, b, max_cache_len or s_kv, k.dtype, x.device)
    L = cache["k"].shape[2]
    if s_kv <= L:
        cache["k"][:, :, :s_kv] = k
        cache["v"][:, :, :s_kv] = v
    else:
        # ring layout: position t lives at slot t % L; the prompt's last L
        # keys land rotated so that decode's (idx % L) writes line up
        shift = s_kv % L
        cache["k"] = torch.roll(k[:, :, -L:], shift, dims=2).contiguous()
        cache["v"] = torch.roll(v[:, :, -L:], shift, dims=2).contiguous()
    cache["idx"] = s_kv
    return out, cache


def _placed_cache(k, v, L: int) -> dict:
    """Prefill's cache for DTensor k and v (b, hk, s, d): L slots laid out
    as ``forward`` lays them, in k's placements (each rank writes its own
    rows and heads; a slot dim that k splits is gathered first unless
    s == L)."""
    from torch.distributed.tensor import DTensor, Replicate

    s = k.shape[2]
    if s == L:
        return {"k": k.contiguous(), "v": v.contiguous(), "idx": s}
    mesh = k.device_mesh
    places = [Replicate() if p.is_partial() or p.is_shard(2) else p for p in k.placements]
    if s > L:  # ring layout, as forward's, each rank on its own rows and heads
        def ring(t):
            local = torch.roll(t.redistribute(mesh, places).to_local()[:, :, -L:], s % L,
                               dims=2).contiguous()
            return DTensor.from_local(local, mesh, places, run_check=False)

        return {"k": ring(k), "v": ring(v), "idx": s}
    shape = (k.shape[0], k.shape[1], L, k.shape[3])
    local = list(shape)
    for dim in range(4):
        local[dim] = pctx.local_range(shape[dim], mesh, places, dim)[1]
    cache = {"idx": s}
    for name, t in (("k", k), ("v", v)):
        slots = torch.zeros(local, dtype=t.dtype, device=t.to_local().device)
        slots[:, :, :s] = t.redistribute(mesh, places).to_local()
        cache[name] = DTensor.from_local(slots, mesh, places, run_check=False, shape=shape,
                                         stride=torch.empty(shape, device="meta").stride())
    return cache


def decode_step(p: Attention, cfg: AttnConfig, x: torch.Tensor, cache: dict, *,
                impl: Optional[str] = None):
    """One-token causal decode; x (b, 1, d_model). Writes the token's key
    and value into ``cache`` in place and returns (out, cache with idx + 1).

    Windowed layers write ring slot idx % L and attend over min(idx + 1, L)
    slots; RoPE is applied at the key's true position before it is stored,
    and attention is permutation-invariant over keys."""
    idx = int(cache["idx"])
    L = cache["k"].shape[2]
    q = _split_heads(p.q(x), cfg.n_heads, cfg.d_head)
    k = _split_heads(p.k(x), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(p.v(x), cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        pos = torch.full((1,), idx, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
    if cfg.window is not None:
        slot, q_offset, kv_len = idx % L, 0, min(idx + 1, L)
    else:  # past-only masking comes from kv_len
        slot, q_offset, kv_len = idx, idx, idx + 1
    if pctx.is_dtensor(cache["k"]):
        _write_slot(cache["k"], k, slot)
        _write_slot(cache["v"], v, slot)
        out = _decode_attention(q, cache["k"], cache["v"], q_offset=q_offset, kv_len=kv_len,
                                scale=cfg.scale, impl=impl)
        return p.o(_merge_heads(out)), {"k": cache["k"], "v": cache["v"], "idx": idx + 1}
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]
    out = ops.flash_attention(q, cache["k"], cache["v"], causal=False, window=None,
                              scale=cfg.scale, q_offset=q_offset, kv_len=kv_len, impl=impl)
    out = p.o(_merge_heads(out))
    return out, {"k": cache["k"], "v": cache["v"], "idx": idx + 1}


def cross_decode_step(p: Attention, cfg: AttnConfig, x: torch.Tensor, cache: dict, *,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Cross-attention during decode: static KV from the encoder cache."""
    q = _split_heads(p.q(x), cfg.n_heads, cfg.d_head)
    if pctx.is_dtensor(cache["k"]):
        out = _decode_attention(q, cache["k"], cache["v"], q_offset=0,
                                kv_len=int(cache["idx"]), impl=impl)
    else:
        out = ops.flash_attention(q, cache["k"], cache["v"], causal=False,
                                  kv_len=int(cache["idx"]), impl=impl)
    return p.o(_merge_heads(out))


def _write_slot(cache, new, slot: int) -> None:
    """Write ``new`` (b, hk, 1, d) into slot ``slot`` of a DTensor cache
    (b, hk, L, d), in place, on the rank whose slice of the slots holds it
    (each its own batch rows and heads)."""
    from torch.distributed.tensor import Replicate

    mesh = cache.device_mesh
    places = [place if place.is_shard(0) or place.is_shard(1) else Replicate()
              for place in cache.placements]
    lo, n = pctx.local_range(cache.shape[2], mesh, cache.placements, 2)
    if lo <= slot < lo + n:
        local = new.redistribute(mesh, places).to_local()
        cache.to_local()[:, :, slot - lo] = local[:, :, 0]


def _decode_attention(q, k, v, *, q_offset: int, kv_len: int, impl, scale=None):
    """One query position (q (b, h, 1, d)) against DTensor caches k, v
    (b, hk, L, d), each rank on its own batch rows and heads; where the
    caches split the slots over a mesh dim, each rank attends to its own
    slots with every query head, and the ranks' parts are merged by their
    log-sum-exp (a max and two sums all-reduced over that dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = k.device_mesh
    h, hk = q.shape[1], k.shape[1]
    qp, op, seq_dims = [], [], []
    for i, place in enumerate(k.placements):
        if place.is_shard(0):
            qp.append(Shard(0))
        elif place.is_shard(1):
            qp.append(Shard(1))
        elif place.is_shard(2):
            qp.append(Replicate())
            seq_dims.append(i)
        else:  # whole caches: the query heads keep their split
            qp.append(Shard(1) if q.placements[i].is_shard(1) else Replicate())
        op.append(qp[-1])
    q = pctx.reduce_partial(q).redistribute(mesh, qp)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    head_dims = [i for i, place in enumerate(qp)
                 if place.is_shard(1) and not k.placements[i].is_shard(1)]
    if head_dims:  # caches whole over these dims: this rank's heads' groups
        lo_h, h_l = pctx.local_range(h, mesh, qp, 1)
        lo_k = pctx.local_range(hk, mesh, k.placements, 1)[0]
        idx = torch.arange(lo_h, lo_h + h_l, device=kl.device) // (h // hk) - lo_k
        kl, vl = kl[:, idx], vl[:, idx]
    lo, n = pctx.local_range(k.shape[2], mesh, k.placements, 2)
    valid = max(min(kv_len - lo, n), 0)
    kw = dict(causal=False, scale=scale, q_offset=q_offset - lo, kv_len=valid, impl=impl)
    if not seq_dims:
        return DTensor.from_local(ops.flash_attention(ql, kl, vl, **kw), mesh, op,
                                  run_check=False)
    out, lse = ops.flash_attention_lse(ql, kl, vl, **kw)  # lse (b, h_l, 1)
    red = [Partial("max") if i in seq_dims else place for i, place in enumerate(op)]
    top = pctx.reduce_partial(DTensor.from_local(lse, mesh, red, run_check=False)).to_local()
    w = torch.where(torch.isfinite(lse), torch.exp(lse - torch.where(
        torch.isfinite(top), top, 0.0)), 0.0)
    red = [Partial() if i in seq_dims else place for i, place in enumerate(op)]
    num = pctx.reduce_partial(DTensor.from_local(out.float() * w[..., None], mesh, red,
                                                 run_check=False))
    den = pctx.reduce_partial(DTensor.from_local(w, mesh, red, run_check=False))
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(q.dtype)
