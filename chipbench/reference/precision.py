"""The arithmetic of the reference's matrix products: float32 with TF32 off
(the reference), or each operand rounded to fp8 (the control).

The control is the reference in the program's place, its matrix products
computed one precision below the bf16 that the configurations state: each
operand rounded to float8 e4m3 with one scale a tensor (its largest
magnitude maps to 448), the product summed in float32; in the backward the
gradient that reaches an operand is rounded to float8 e5m2 the same way.
Everything else (norms, softmax, the SSD's state products, the optimizer)
stays float32 in both.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_float32() -> None:
    """Full float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    return (x.float() / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """``mm(a, b)``: a @ b as the precision computes it."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 or fp8")
        self.name = name

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _Fp8.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))
