"""Plain float32 training steps of the configuration as a data-parallel
deployment states it: next-token cross-entropy, int8 error-feedback
gradient compression over the data-parallel ranks, global-norm clipping
and AdamW (decoupled weight decay, warm-up then cosine schedule), with the
parameters stored in the model's dtype.

One rank of the deployment runs here, so the reduction over ranks is the
identity, but the wire format is kept: each gradient goes through the
codec three times, as the deployment's reduce-scatter and all-gather
would send it (quantized with its residual, the sum re-quantized for the
all-gather, and dequantized). The codec: blocks of 256, scale
amax * (1/127) (1 for a zero block), q = round-half-even(x / scale)
clipped to +-127.

The parameters are float32 leaves for the products and the gradients, and
after each update each is rounded to the dtype the configuration stores
it in: the model's, or float32 for the Mamba2 scalars.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from chipbench.reference import lm
from chipbench.reference.precision import Precision

BLOCK = 256


def codec_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize a flat f32 vector to int8 in blocks and back (its length
    kept)."""
    n = x.numel()
    pad = (-n) % BLOCK
    xb = F.pad(x, (0, pad)).reshape(-1, BLOCK)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[:, None]), -127.0, 127.0)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return (q * scale[:, None]).reshape(-1)[:n]


@torch.no_grad()
def compress_(grads: Dict[str, torch.Tensor], residuals: Dict[str, torch.Tensor]) -> None:
    """Error-feedback compression on one rank, in place: g <- the wire's
    value of g + r, r <- (g + r) minus its quantized value."""
    for name, g in grads.items():
        r = residuals[name]
        flat = g.reshape(-1) + r.reshape(-1)
        sent = codec_roundtrip(flat)
        r.view(-1).copy_(flat - sent)
        g.view(-1).copy_(codec_roundtrip(codec_roundtrip(sent)))


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``peak_lr``, then cosine decay to end_lr_frac of it."""
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    end = opt["peak_lr"] * opt["end_lr_frac"]
    return end + 0.5 * (opt["peak_lr"] - end) * (1.0 + math.cos(math.pi * t))


@torch.no_grad()
def adamw_(opt: dict, params, grads, state: dict, stored) -> None:
    """One AdamW step in place, with the gradients clipped to a global norm
    of ``clip_norm`` first; each new parameter is rounded to the dtype it
    is stored in (``stored[name]``)."""
    state["step"] += 1
    t = state["step"]
    lr = lr_at(opt, t)
    norm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
    b1, b2 = opt["b1"], opt["b2"]
    for name, p in params.items():
        g = grads[name] * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        delta = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
        new = p - lr * (delta + opt["weight_decay"] * p)
        p.copy_(new.to(stored[name]).float())


def run(cfg: dict, weights: Callable[[], Dict[str, torch.Tensor]], batches: List[Callable],
        opt: dict, prec: Precision, *, half_batch: bool = False, frozen: bool = False) -> dict:
    """Train from ``weights()`` (each stored in the dtype it is drawn in) on
    ``batches`` (each a function giving (tokens, labels)); returns what the judge compares with the program's
    run: each step's loss, each leaf's first gradient as the optimizer
    took it (norms, from the first moment after step 1), and each leaf's
    change over all the steps (norms). Two faults can be planted:
    ``half_batch``, each step sees only the first half of its rows;
    ``frozen``, each step leaves its state unchanged."""
    first = weights()
    stored = {k: w.dtype for k, w in first.items()}
    params = {k: w.float().clone().requires_grad_(True) for k, w in first.items()}
    del first
    state = {"step": 0, "m": {k: torch.zeros_like(p) for k, p in params.items()},
             "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    residuals = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        toks, labels = batch()
        if half_batch:
            toks, labels = toks[:toks.shape[0] // 2], labels[:labels.shape[0] // 2]
        loss = lm.loss(cfg, params, toks, labels, prec)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        del loss
        if not frozen:
            compress_(grads, residuals)
            adamw_(opt, params, grads, state, stored)
        del grads
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
                          for k, m in state["m"].items()}
    del state, residuals
    first = weights()
    change_norms = {k: float(torch.linalg.vector_norm(p.detach() - first[k].float()))
                    for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
