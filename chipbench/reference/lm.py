"""Plain float32 language models of the benchmark's configurations, written
from the configuration files' published keys; imports nothing of the
program.

A configuration names its ``family``; ``chipbench/reference/<family>.py``
holds that family's sizes (``dims``), its parameters (``param_specs``),
one layer (``layer``), the final norm, and its count of model FLOPs
(``matrix_weights``, ``mixer_forward``). This module holds what the
families share and runs the model.

Two hooks are optional. ``layer_params(params, i)`` gives layer ``i`` its
tensors: without it the ``blocks.{i}.`` slice; with it, also tensors that
several layers share, which ``param_specs`` lists once and the hook hands
out as the very objects of ``params``, so each is drawn once and its
gradient sums over every use. ``READS_H0 = True`` has every layer called
with ``h0=``, the embedding's output, besides its input.

Parameters are ``{name: tensor}`` under the names of ``param_specs``; the
benchmark draws them (``chipbench.inputs``) and hands the same values to
the program. Matrices multiply as ``x @ w`` with w (d_in, d_out). Every
product goes through a ``Precision`` (float32, or fp8 for the control).
Under autograd each layer is recomputed in the backward
(``torch.utils.checkpoint``), and attention and the loss run in blocks, so
that a full-width model trains in the card's memory.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from chipbench.reference.precision import Precision

LOSS_ROWS = 1024  # rows of logits a loss block holds


def family(cfg: dict):
    return importlib.import_module(f"chipbench.reference.{cfg['family']}")


def dims(cfg: dict) -> dict:
    """The sizes the model is built from (``layers``, ``d``, ``vocab`` and
    the family's own)."""
    return family(cfg).dims(cfg)


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in a fixed order. ``init``:
    ``normal`` N(0, initializer_range²) and ``one_plus_normal`` 1 + N(0,
    initializer_range²), in the model's dtype; ``dt_bias``, ``a_log``,
    ``one_plus_normal_f32``: the Mamba2 scalars a head, in float32."""
    return family(cfg).param_specs(cfg)


def ckpt(fn, *args):
    """fn(*args), recomputed in the backward under autograd."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps):
    return x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """Rotate interleaved pairs (x[..., 2i], x[..., 2i + 1]) of x (..., s,
    dh) by position * theta^(-2i / dh)."""
    s, dh = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def _attention_block(q, k, v, prec: Precision):
    """Causal softmax attention of query heads q (r, s, dh) over one kv
    head k, v (s, dh)."""
    s, dh = k.shape
    scores = prec.mm(q, k.t()) / math.sqrt(dh)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return prec.mm(probs, v)


def causal_attention(q, k, v, prec: Precision):
    """q (b, H, s, dh) over k, v (b, Hk, s, dh), query head i on kv head
    i // (H / Hk), one (sequence, kv head) block at a time -> (b, H, s, dh)."""
    b, H, s, dh = q.shape
    Hk = k.shape[1]
    rep = H // Hk
    heads = [ckpt(_attention_block, q[i, j * rep:(j + 1) * rep], k[i, j], v[i, j], prec)
             for i in range(b) for j in range(Hk)]
    return torch.stack(heads).reshape(b, H, s, dh)


def _layer_params(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    pre = f"blocks.{i}."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def _layer_fn(fam, cfg: dict, m: dict, params: Dict[str, torch.Tensor], i: int,
              prec: Precision, h0: torch.Tensor):
    """Layer ``i`` as ``f(h, kv_out=None)``: the family's ``layer`` on
    ``layer_params(params, i)`` (the ``blocks.{i}.`` slice by default), and
    with ``h0=`` where the family sets ``READS_H0``."""
    p = getattr(fam, "layer_params", _layer_params)(params, i)
    kw = {"h0": h0} if getattr(fam, "READS_H0", False) else {}

    def f(h, kv_out=None):
        return fam.layer(cfg, m, p, h, prec, kv_out, **kw)

    return f


def hidden(cfg: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prec: Precision, kv_layer: Optional[int] = None):
    """tokens (b, s) -> (final hidden states (b, s, d), [k, v] of layer
    ``kv_layer`` (b, hk, s, dh), k after RoPE, or None)."""
    fam = family(cfg)
    m = fam.dims(cfg)
    h0 = h = params["embed.table"][tokens]
    kv = [] if kv_layer is not None else None
    for i in range(m["layers"]):
        f = _layer_fn(fam, cfg, m, params, i, prec, h0)
        h = f(h, kv) if i == kv_layer else ckpt(f, h)
    return fam.final_norm(cfg, params, h), kv


@torch.no_grad()
def last_kv_layer(cfg: dict) -> int:
    """The last layer whose ``kv_out`` receives [k, v]: the layer that a
    prefill's last attention cache (``chipbench.port.last_kv``) is compared
    with. Each layer from the last runs once on the meta device, shapes
    alone. Raises ValueError where no layer fills ``kv_out``."""
    fam = family(cfg)
    m = fam.dims(cfg)
    params = {n: torch.empty(shape, device="meta") for n, shape, _ in fam.param_specs(cfg)}
    h = torch.empty((1, 1, m["d"]), device="meta")
    for i in range(m["layers"] - 1, -1, -1):
        kv = []
        _layer_fn(fam, cfg, m, params, i, Precision("float32"), h)(h, kv)
        if kv:
            return i
    raise ValueError(f"{cfg['arch']}: no layer of the reference's {cfg['family']} family "
                     f"fills kv_out, so a prefill has no attention cache to compare")


def logits(cfg, params, h, prec: Precision) -> torch.Tensor:
    return prec.mm(h, params["embed.table"].t())


def _nll_sum(h, table, labels, prec: Precision):
    z = prec.mm(h, table.t())
    return (torch.logsumexp(z, dim=-1) - z.gather(-1, labels[:, None])[:, 0]).sum()


def loss(cfg: dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, in blocks of
    ``LOSS_ROWS`` rows of logits."""
    h, _ = hidden(cfg, params, tokens, prec)
    h, labels = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
    total = sum(ckpt(_nll_sum, h[i:i + LOSS_ROWS], params["embed.table"],
                     labels[i:i + LOSS_ROWS], prec)
                for i in range(0, h.shape[0], LOSS_ROWS))
    return total / labels.numel()
