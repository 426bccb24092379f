"""AdamW with decoupled weight decay, global-norm clipping and the
warm-up + cosine schedule, the reference's ``optim/adamw.py``.

The expressions and their order are the reference's: the clip scale is
cast to each gradient's dtype before it multiplies, the moments are f32
whatever the parameter's dtype, and the new parameter is
``(p_f32 - lr * delta)`` cast back to ``p``'s dtype. The clipped gradient
is not rounded back to a bf16 gradient's dtype before the moments take
it: the reference, compiled, does not round it either (XLA's excess
precision keeps ``g * scale`` in f32 inside the fused update).

Unlike the reference, which returns new parameters and moments,
``update`` works IN PLACE on the parameters, the moments and the step
count (under ``torch.no_grad()``): at full width a functional update
would hold a second copy of params, m and v (about 30 GB for
starcoder2-3b), which does not fit beside the rest on one 80 GB card.

Parameters and gradients are ``{name: tensor}`` dicts keyed like
``model.named_parameters()``; the state is
``{"m": {name: f32}, "v": {name: f32}, "step": int64 0-d tensor}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    end_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to end_lr_frac·peak, in f32."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    end = cfg.peak_lr * cfg.end_lr_frac
    cos = end + 0.5 * (cfg.peak_lr - end) * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Dict[str, torch.Tensor]) -> dict:
    """Zero f32 moments shaped like each parameter, and step 0."""
    some = next(iter(params.values()))
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int64, device=some.device),
    }


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x²) in f32, leaf by leaf in
    order, as the reference's Python ``sum``."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)) cast to each
    one's dtype, norm), as new tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
           grads: Dict[str, torch.Tensor], state: dict) -> Dict[str, torch.Tensor]:
    """One AdamW step, IN PLACE on ``params`` and ``state`` (``grads`` are
    read only). Returns the metrics {lr, grad_norm} (0-d f32 tensors)."""
    state["step"].add_(1)
    step = state["step"]
    lr = schedule(cfg, step)
    if any(_is_dtensor(g) for g in grads.values()):
        grads = {k: _as_moment(g, state["m"][k]) for k, g in grads.items()}
    gnorm = global_norm(grads)
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm, cfg.clip_norm)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device),
                          stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device),
                          stepf)
    for name, p in params.items():
        g = grads[name]
        gf = g.to(torch.float32)
        if scale is not None:
            gf = gf * scale.to(g.dtype).to(torch.float32)
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        delta.add_(cfg.weight_decay * pf)
        new = pf - lr * delta
        if _is_dtensor(p):  # the ZeRO-1 shards' update gathered in p's dtype
            new = new.to(p.dtype)
        p.copy_(new)
    return {"lr": lr, "grad_norm": gnorm}


def _is_dtensor(t) -> bool:
    return hasattr(t, "placements")


def _as_moment(g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its moment's placements (a partial sum over
    the data axis reduce-scattered onto ZeRO-1's shards); else ``g``."""
    if not _is_dtensor(g) or not _is_dtensor(m) or tuple(g.placements) == tuple(m.placements):
        return g
    return g.redistribute(m.device_mesh, m.placements)
