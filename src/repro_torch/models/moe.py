"""Top-k mixture-of-experts FFN with GShard-style capacity dispatch, the
reference's ``models/moe.py``.

Routing: softmax router (f32), top-k expert choice per token, per-expert
capacity C = ceil(tokens/E · k · capacity_factor). Tokens beyond capacity
are dropped (their combine weight is zero; the residual carries them).
Slots are handed out k-major (every token's first choice before any
second choice), in token order.

The expert products are plain batched matmuls (no kernel of the
reference's computes them). The reference's three-operand combine einsum
is built here by a scatter of each kept choice's gate into its (expert,
slot): each (token, expert) pair holds at most one choice, so every
element is the reference's value exactly, and no (b, s, k, E, C) tensor
exists.

Aux outputs: GShard load-balance loss and router z-loss.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.parallel import context as pctx


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int  # per-expert FFN hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    act: str = "silu"
    gated: bool = True


class ExpertLinear(nn.Module):
    """One linear layer of every expert, stacked: w (E, d_in, d_out)."""

    def __init__(self, n: int, d_in: int, d_out: int, *, dtype, generator, device):
        super().__init__()
        self.w = common.param(common.normal((n, d_in, d_out), std=common.DEFAULT_INIT_STD,
                                            dtype=dtype, generator=generator,
                                            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, n, d_in) -> (E, n, d_out)."""
        return torch.bmm(x, self.w)


class Experts(nn.Module):
    """The experts' MLPs, stacked (the reference's ``experts`` pytree)."""

    def __init__(self, cfg: MoEConfig, dtype, *, generator, device):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, device=device)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.act = cfg.act
        self.up = ExpertLinear(E, d, f, **kw)
        self.down = ExpertLinear(E, f, d, **kw)
        self.gate = ExpertLinear(E, d, f, **kw) if cfg.gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, n, d) -> (E, n, d), ``common.MLP`` per expert."""
        h = self.up(x)
        if self.gate is not None:
            h = common.activation(self.act)(self.gate(x)) * h
        else:
            h = common.activation(self.act)(h)
        return self.down(h)


class MoE(nn.Module):
    """The router (float32 in every model dtype) and the stacked experts."""

    def __init__(self, cfg: MoEConfig, dtype, *, generator, device):
        super().__init__()
        self.router = common.Linear(cfg.d_model, cfg.n_experts, bias=False,
                                    dtype=torch.float32, generator=generator, device=device)
        self.experts = Experts(cfg, dtype, generator=generator, device=device)


def init(cfg: MoEConfig, dtype, *, generator, device) -> MoE:
    return MoE(cfg, dtype, generator=generator, device=device)


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    c = math.ceil(tokens_per_group / cfg.n_experts * cfg.top_k * cfg.capacity_factor)
    return max(int(c), 4)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on ties, as ``jax.lax.top_k`` (``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def combine_weights(cfg: MoEConfig, probs: torch.Tensor):
    """The dispatch of router probabilities probs (b, s, E): (combine
    (b, s, E, C) f32, each kept choice's normalized gate at (its expert,
    its slot) and 0 elsewhere; the experts chosen (b, s, K)).

    Slots are handed out k-major: a choice's slot is the count of earlier
    choices of its expert over (k, token); a slot at or past C drops it."""
    b, s, E = probs.shape
    K, C = cfg.top_k, capacity(cfg, s)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx.transpose(1, 2).reshape(b, K * s), E)
    earlier = (torch.cumsum(onehot, dim=1) - onehot).reshape(b, K, s, E).transpose(1, 2)
    pos = torch.gather(earlier, -1, gate_idx[..., None])[..., 0]  # (b, s, K)
    slot = gate_idx * C + torch.clamp_max(pos, C - 1)
    # a token's K experts differ, so no two choices share an element
    combine = torch.zeros((b, s, E * C), dtype=torch.float32, device=probs.device)
    combine = combine.scatter_add(-1, slot, gate_vals * (pos < C))
    return combine.reshape(b, s, E, C), gate_idx


def _expert_split(p: MoE, combine: torch.Tensor) -> torch.Tensor:
    """``combine`` (b, s, E * C): a DTensor's (expert, slot) dim split
    with the experts (whole experts a rank where the rules split them), so
    that each rank dispatches to, and combines from, its own experts only;
    the combine product is then a partial sum over them, all-reduced.
    Anything else is returned as it is."""
    w = p.experts.up.w
    if not (pctx.is_dtensor(combine) and pctx.is_dtensor(w)):
        return combine
    from torch.distributed.tensor import Shard

    places = [Shard(2) if wp.is_shard(0) else cp
              for wp, cp in zip(w.placements, combine.placements)]
    return combine.redistribute(combine.device_mesh, places)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return pctx.local_bmm(a, b) if pctx.is_dtensor(a) else torch.bmm(a, b)


def forward(p: MoE, cfg: MoEConfig, x: torch.Tensor):
    """x (b, s, d) -> (y, aux) with aux = {load_balance_loss, router_z_loss}."""
    b, s, d = x.shape
    E = cfg.n_experts
    C = capacity(cfg, s)

    logits = p.router(x.float())  # (b, s, E)
    probs = torch.softmax(logits, dim=-1)
    combine, gate_idx = combine_weights(cfg, probs)
    combine = _expert_split(p, combine.reshape(b, s, E * C))
    dispatch = (combine > 0).to(x.dtype)

    expert_in = _bmm(dispatch.transpose(1, 2), x)  # (b, E*C, d)
    expert_in = expert_in.reshape(b, E, C, d).transpose(0, 1).reshape(E, b * C, d)
    expert_out = p.experts(expert_in)  # (E, b*C, d)
    expert_out = expert_out.reshape(E, b, C, d).transpose(0, 1).reshape(b, E * C, d)
    y = _bmm(combine.to(x.dtype), expert_out)  # (b, s, d)

    # aux losses (GShard §2.2 / ST-MoE z-loss)
    frac_tokens = torch.nn.functional.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return y, {"load_balance_loss": lb_loss, "router_z_loss": z_loss}
