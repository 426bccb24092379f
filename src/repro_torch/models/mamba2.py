"""Mamba2 block (state-space duality) with a decode step, the reference's
``models/mamba2.py`` (arXiv:2405.21060): one input projection gives
[z | x | B | C | dt], a causal depthwise conv over (x, B, C), softplus dt
with a learned bias, negative head decays A, SSD sequence mixing
(``kernels.ops.ssd_scan``: the Hopper chunk kernel on the card), the D
skip, a gated RMSNorm and the output projection.

Decode keeps (conv, ssm) state per layer and runs the recurrent
``ops.ssm_decode_step`` (plain torch, as in the reference).
``dt_bias``, ``A_log`` and ``D`` are float32 in every model dtype.
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
class Mamba2Config:
    d_model: int
    d_inner: int  # usually 2 * d_model
    d_state: int  # N
    head_dim: int  # P
    n_groups: int = 1  # B/C groups (G)
    d_conv: int = 4
    chunk: int = 128

    # not a field: ``GroupedNormMamba2Config`` sets it, so the configs of the
    # archs keep the reference's fields
    norm_groups = 1  # groups of channels the gated RMSNorm normalises apart

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} % head_dim {self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def d_in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


@dataclasses.dataclass(frozen=True)
class GroupedNormMamba2Config(Mamba2Config):
    """Mamba2 whose gated RMSNorm takes its statistics over ``norm_groups``
    equal slices of the d_inner channels (Zamba2-7B: one a B/C group, as
    mamba_ssm's ``RMSNormGated(group_size=d_inner // ngroups)``)."""

    norm_groups: int = 1


class Mamba2(nn.Module):
    def __init__(self, cfg: Mamba2Config, dtype, *, generator: torch.Generator, device):
        super().__init__()
        h = cfg.n_heads
        kw = dict(dtype=dtype, generator=generator, device=device)
        self.in_proj = common.Linear(cfg.d_model, cfg.d_in_proj, bias=False, **kw)
        self.conv_w = common.param(common.normal(
            (cfg.d_conv, cfg.conv_channels), std=0.1, **kw))
        self.conv_b = common.param(torch.zeros((cfg.conv_channels,), dtype=dtype,
                                                device=device))
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand((h,), generator=generator, device=device) * (hi - lo) + lo
        self.dt_bias = common.param(torch.log(torch.expm1(torch.exp(u))).float())
        u = torch.rand((h,), generator=generator, device=device) * 15.0 + 1.0
        self.A_log = common.param(torch.log(u).float())
        self.D = common.param(torch.ones((h,), dtype=torch.float32, device=device))
        self.norm_scale = common.param(torch.ones((cfg.d_inner,), dtype=dtype,
                                                   device=device))
        self.out_proj = common.Linear(cfg.d_inner, cfg.d_model, bias=False, **kw)


def init(cfg: Mamba2Config, dtype, *, generator: torch.Generator, device) -> Mamba2:
    return Mamba2(cfg, dtype, generator=generator, device=device)


def _split_proj(cfg: Mamba2Config, zxbcdt: torch.Tensor):
    """(z, xbc, dt) of the input projection; on DTensors with in_proj's
    columns split over the model axis, each split in even chunks of its
    own (xbc as ``conv_w``'s channels), so that every rank goes on with
    its own heads (``pctx.regroup_columns``)."""
    return pctx.regroup_columns([zxbcdt], [cfg.d_inner, cfg.conv_channels, cfg.n_heads])


def _split_conv(cfg: Mamba2Config, xbc: torch.Tensor):
    """(x, B, C) of the conv's output; on DTensors x split by heads as z
    is, B and C whole on every rank (each rank's heads read their
    groups)."""
    gn = cfg.n_groups * cfg.d_state
    xs, B, C = pctx.regroup_columns([xbc], [cfg.d_inner, gn, gn])
    return (xs, *map(_whole_last, (B, C)))


def _whole_last(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` gathered over the mesh dims that split its last dim;
    anything else as it is."""
    if not pctx.is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(t.ndim - 1) else p
                                          for p in t.placements])


def _causal_conv(w: torch.Tensor, b: torch.Tensor, xbc: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width d_conv over xbc (batch, s, ch); taps
    summed in order i = 0 .. d_conv - 1, as the reference."""
    dconv = w.shape[0]
    pad = (torch.zeros((xbc.shape[0], dconv - 1, xbc.shape[2]), dtype=xbc.dtype,
                       device=xbc.device) if prev is None else prev)
    xp = torch.cat([pad, xbc], dim=1)  # (b, s + dconv - 1, ch)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, dconv):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    out = torch.nn.functional.silu(out + b)
    new_state = xp[:, -(dconv - 1):] if dconv > 1 else pad[:, :0]
    return out, new_state


def _gated_rmsnorm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                   eps: float = 1e-6, groups: int = 1) -> torch.Tensor:
    yf = y.float() * torch.nn.functional.silu(z.float())
    if groups > 1:  # each group of channels on its own statistics
        if pctx.is_dtensor(yf):
            raise NotImplementedError("a gated RMSNorm in groups on DTensors")
        yg = yf.unflatten(-1, (groups, -1))
        yg = yg * torch.rsqrt((yg * yg).mean(dim=-1, keepdim=True) + eps)
        return (yg.flatten(-2) * scale.float()).to(y.dtype)
    sq = yf * yf
    if pctx.is_dtensor(sq):  # split over the channels: a partial sum, all-reduced here
        ms = pctx.reduce_partial(sq.sum(dim=-1, keepdim=True)) / sq.shape[-1]
    else:
        ms = sq.mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _ssd(x, dt, A, B, C, **kw):
    """``ops.ssd_scan``; on DTensors each rank scans (the kernel, or its
    plain version on the host) its own batch rows and heads over the whole
    sequence, with its heads' groups of B and C: the scan is local to a
    head."""
    if not pctx.is_dtensor(x):
        return ops.ssd_scan(x, dt, A, B, C, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    xp = [Shard(0) if place.is_shard(0) else Shard(2) if place.is_shard(2) else Replicate()
          for place in x.placements]  # (b, s, h, p); dt (b, s, h) alike
    ap = [Shard(0) if place.is_shard(2) else Replicate() for place in xp]
    bcp = [Shard(0) if place.is_shard(0) else Replicate() for place in xp]
    h, g = x.shape[2], B.shape[2]
    lo_h, h_l = pctx.local_range(h, mesh, xp, 2)
    # B and C whole over a mesh dim that splits the heads take gradient
    # from this rank's heads only: a partial sum over that dim
    bcg = [Partial() if bp.is_replicate() and p.is_shard() else bp for bp, p in zip(bcp, xp)]
    Bl, Cl = (t.redistribute(mesh, bcp).to_local(grad_placements=bcg) for t in (B, C))
    if h_l < h:  # one group a local head
        idx = torch.arange(lo_h, lo_h + h_l, device=Bl.device) // (h // g)
        Bl, Cl = Bl[:, :, idx], Cl[:, :, idx]
    out = ops.ssd_scan(x.redistribute(mesh, xp).to_local(),
                       dt.redistribute(mesh, xp).to_local(),
                       A.redistribute(mesh, ap).to_local(grad_placements=[
                           Partial() if a.is_replicate() and p.is_shard() else a
                           for a, p in zip(ap, xp)]), Bl, Cl, **kw)
    if not kw.get("return_state"):
        return DTensor.from_local(out, mesh, xp)
    state_p = [Shard(1) if place.is_shard(2) else place for place in xp]  # (b, h, n, p)
    return DTensor.from_local(out[0], mesh, xp), DTensor.from_local(out[1], mesh, state_p)


def _ssm_step(hstate, x, dt, A, B, C):
    """``ops.ssm_decode_step``; on DTensors each rank steps its own batch
    rows and heads (the state (b, h, n, p) as the cache rules split it),
    with its heads' groups of B and C, as ``_ssd`` scans them."""
    if not pctx.is_dtensor(hstate):
        return ops.ssm_decode_step(hstate, x, dt, A, B, C)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = hstate.device_mesh
    sp = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in hstate.placements]
    xp = sp  # x (b, h, p) and dt (b, h) split as the state's (b, h)
    ap = [Shard(0) if p.is_shard(1) else Replicate() for p in sp]
    bcp = [Shard(0) if p.is_shard(0) else Replicate() for p in sp]
    h, g = hstate.shape[1], B.shape[1]
    lo_h, h_l = pctx.local_range(h, mesh, sp, 1)
    Bl, Cl = (pctx.reduce_partial(t).redistribute(mesh, bcp).to_local() for t in (B, C))
    if h_l < h:  # the groups of this rank's heads, one a local head
        idx = torch.arange(lo_h, lo_h + h_l, device=Bl.device) // (h // g)
        Bl, Cl = Bl[:, idx], Cl[:, idx]
    state, y = ops.ssm_decode_step(
        hstate.redistribute(mesh, sp).to_local(),
        pctx.reduce_partial(x).redistribute(mesh, xp).to_local(),
        pctx.reduce_partial(dt).redistribute(mesh, xp).to_local(),
        A.redistribute(mesh, ap).to_local(), Bl, Cl)
    return (DTensor.from_local(state, mesh, sp, run_check=False),
            DTensor.from_local(y, mesh, xp, run_check=False))


def forward(p: Mamba2, cfg: Mamba2Config, x: torch.Tensor, *, return_state: bool = False,
            impl: Optional[str] = None):
    """x (b, s, d_model) -> (b, s, d_model) [, state {conv, ssm}]."""
    local = pctx.local_rows_of(p, x)
    if local is not None:  # whole weights: each rank its own rows
        lp, to_local, wrap = local
        return wrap(forward(lp, cfg, to_local(x), return_state=return_state, impl=impl))
    b, s, _ = x.shape
    g, n, h, pd = cfg.n_groups, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt_raw = _split_proj(cfg, p.in_proj(x))
    xbc, conv_state = _causal_conv(p.conv_w, p.conv_b, xbc)
    xs, Bc, Cc = _split_conv(cfg, xbc)
    Bc, Cc = Bc.reshape(b, s, g, n), Cc.reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(dt_raw.float() + p.dt_bias)  # (b, s, h)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(b, s, h, pd)
    out = _ssd(xh, dt, A, Bc, Cc, chunk=min(cfg.chunk, max(16, s)),
               return_state=return_state, impl=impl)
    y, ssm_state = out if return_state else (out, None)
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = _gated_rmsnorm(p.norm_scale, y, z, groups=cfg.norm_groups)
    y = p.out_proj(y)
    if return_state:
        # a copy: the conv state is a view of the conv's whole input, which
        # it would keep alive in the cache (at Zamba2-7B's prefill, 81
        # layers x 243 MB a 16 x 1,024 batch)
        return y, {"conv": conv_state.clone(), "ssm": ssm_state}
    return y


def make_state(cfg: Mamba2Config, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_channels), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }


def decode_step(p: Mamba2, cfg: Mamba2Config, x: torch.Tensor, state: dict):
    """x (b, 1, d_model); state {conv (b, d_conv-1, ch), ssm (b, h, n, p)}."""
    local = pctx.local_rows_of(p, x)
    if local is not None:  # whole weights: each rank its own rows
        lp, to_local, wrap = local
        return wrap(decode_step(lp, cfg, to_local(x), to_local(state)))
    b = x.shape[0]
    g, n, h, pd = cfg.n_groups, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt_raw = _split_proj(cfg, p.in_proj(x))
    xbc, conv_state = _causal_conv(p.conv_w, p.conv_b, xbc, prev=state["conv"])
    xs, Bc, Cc = _split_conv(cfg, xbc)
    Bc, Cc = Bc.reshape(b, g, n), Cc.reshape(b, g, n)
    dt = torch.nn.functional.softplus(dt_raw[:, 0].float() + p.dt_bias)  # (b, h)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(b, h, pd)
    ssm_new, y = _ssm_step(state["ssm"], xh, dt, A, Bc, Cc)
    y = y + p.D[None, :, None] * xh.float()
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = _gated_rmsnorm(p.norm_scale, y, z, groups=cfg.norm_groups)
    y = p.out_proj(y)
    return y, {"conv": conv_state, "ssm": ssm_new}
