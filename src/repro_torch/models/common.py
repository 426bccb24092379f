"""Neural-net primitives as torch modules, the reference's
``models/common.py``.

Conventions kept from the reference:

* weights are stored (d_in, d_out) and applied as ``x @ w``;
* normalization statistics run in float32 (population variance, eps 1e-6)
  and return the input's dtype;
* ``unembed`` takes bf16 operands, accumulates in float32 and returns f32
  logits;
* GELU is the tanh approximation (``jax.nn.gelu``'s default; ``"gelu_erf"``
  is the exact one, Zamba2-7B's); RoPE rotates interleaved pairs
  ``x[..., 0::2]``, ``x[..., 1::2]``.

Random init draws from a ``torch.Generator``: the same scheme as the
reference (normal times std, cast to the model's dtype), but not the same
numbers as ``jax.random``. The tests carry the reference's weights across
(``convert.lm_params_from_reference``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.parallel import context as pctx

DEFAULT_INIT_STD = 0.02


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of a serving model: no gradient is tracked."""
    return nn.Parameter(t, requires_grad=False)


def normal(shape, *, std: float, dtype, generator: torch.Generator,
           device) -> torch.Tensor:
    """N(0, std^2) drawn in float32 on ``device``, cast to ``dtype``. On the
    meta device (shapes only, as ``engine.terms_analytic`` counts) nothing
    is drawn and ``generator`` may be None."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)


class Linear(nn.Module):
    """y = x @ w (+ b); w (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool, dtype,
                 generator: torch.Generator, device, std: Optional[float] = None):
        super().__init__()
        std = DEFAULT_INIT_STD if std is None else std
        self.w = param(normal((d_in, d_out), std=std, dtype=dtype,
                               generator=generator, device=device))
        self.b = (param(torch.zeros((d_out,), dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if pctx.is_dtensor(x):
            return pctx.local_product(torch.matmul, x, self.w, self.b)
        return _affine(x, self.w, self.b)


def _affine(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return y


class Embed(nn.Module):
    """Token embedding table (vocab, d), tied to the unembedding."""

    def __init__(self, vocab: int, d: int, *, dtype, generator: torch.Generator,
                 device, std: Optional[float] = None):
        super().__init__()
        std = DEFAULT_INIT_STD if std is None else std
        self.table = param(normal((vocab, d), std=std, dtype=dtype,
                                   generator=generator, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if pctx.is_dtensor(self.table):
            return pctx.vocab_lookup(self.table, ids)
        return self.table[ids]


def _matmul_f32(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w_t (d, v) with float32 accumulation and output.

    A bf16 product on the card goes through ``torch.mm(..., out_dtype=f32)``
    (bf16 operands, f32 accumulate, no f32 copy of the weight); elsewhere
    the operands are upcast, which computes the same function (products of
    bf16 values are exact in f32).
    """
    if pctx.is_dtensor(x):
        return pctx.local_product(_matmul_f32_of, x, w_t)
    return _matmul_f32_of(x, w_t)


def _matmul_f32_of(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        y = _MatmulF32Out.apply(x.reshape(-1, x.shape[-1]), w_t)
        return y.reshape(*x.shape[:-1], w_t.shape[1])
    return x.float() @ w_t.float()


class _MatmulF32Out(torch.autograd.Function):
    """``torch.mm(x, w_t, out_dtype=f32)`` with a backward (the op has
    none): the f32 output gradient is rounded to the operands' dtype once,
    and dx, dw come from two products in that dtype with f32 accumulation,
    so no f32 copy of a (vocab, d) table is made."""

    @staticmethod
    def forward(ctx, x, w_t):
        ctx.save_for_backward(x, w_t)
        return torch.mm(x, w_t, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w_t = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w_t.t(), x.t() @ g


def unembed(embed: Embed, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x (..., d) -> f32 logits (..., vocab)."""
    return _matmul_f32(x, embed.table.t())


def linear_f32out(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """Linear with f32 accumulation and output (the untied lm_head)."""
    y = _matmul_f32(x, p.w)
    if p.b is not None:
        y = y + p.b.float()
    return y


class Norm(nn.Module):
    """RMSNorm or LayerNorm with f32 statistics, eps 1e-6."""

    def __init__(self, d: int, *, kind: str, dtype, device):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(kind)
        self.kind = kind
        self.scale = param(torch.ones((d,), dtype=dtype, device=device))
        self.bias = (param(torch.zeros((d,), dtype=dtype, device=device))
                     if kind == "layernorm" else None)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            ms = (xf * xf).mean(dim=-1, keepdim=True)
            y = xf * torch.rsqrt(ms + eps) * self.scale.float()
        else:
            mu = xf.mean(dim=-1, keepdim=True)
            var = xf.var(dim=-1, keepdim=True, unbiased=False)  # population, as jnp.var
            y = (xf - mu) * torch.rsqrt(var + eps)
            y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


def rope_frequencies(d_head: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """x (b, h, s, d); positions (s,) or (b, s). Interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)
    ang = positions[..., None].float() * freqs  # (..., s, d/2)
    ang = ang[None, None] if ang.dim() == 2 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")  # jax.nn.gelu's default


ACTIVATIONS = {"silu": torch.nn.functional.silu, "gelu": _gelu_tanh,
               "gelu_erf": torch.nn.functional.gelu, "relu": torch.relu}


def activation(name: str):
    return ACTIVATIONS[name]


class MLP(nn.Module):
    """down(act(gate(x)) * up(x)) when gated, else down(act(up(x)))."""

    def __init__(self, d: int, d_ff: int, *, gated: bool, bias: bool, act: str,
                 dtype, generator: torch.Generator, device):
        super().__init__()
        kw = dict(bias=bias, dtype=dtype, generator=generator, device=device)
        self.act = act
        self.up = Linear(d, d_ff, **kw)
        self.down = Linear(d_ff, d, **kw)
        self.gate = Linear(d, d_ff, **kw) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            h = activation(self.act)(self.gate(x)) * h
        else:
            h = activation(self.act)(h)
        return self.down(h)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32, the reference's ``cross_entropy``:
    logits (..., v), labels (...) int; with ``mask``, the masked mean."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])
    if pctx.is_dtensor(logits):
        # a vocab-split row's max, sum and gold logit are all-reduced where
        # they are made, not gathered or scattered over the sequence
        top = pctx.reduce_partial(logits.amax(dim=-1, keepdim=True)).detach()
        total = pctx.reduce_partial(torch.exp(logits - top).sum(dim=-1, keepdim=True))
        logz = torch.log(total) + top
        nll = (logz - pctx.reduce_partial(gold))[..., 0]
    else:
        # the trailing axis goes after the subtraction, as the reference
        nll = (torch.logsumexp(logits, dim=-1)[..., None] - gold)[..., 0]
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))
