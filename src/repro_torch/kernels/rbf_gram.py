"""Wrapper of the Hopper RBF Gram kernel (``csrc/rbf_gram.cu``).

K[b, i, j] = exp(-gamma ||x[b, i] - y[b, j]||^2) for x (b, n, d) and
y (b, m, d) float32 CUDA tensors, in one launch over the whole batch.
The plain version is ``ref.rbf_gram_ref``; ``ops.rbf_gram`` dispatches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_D = 16  # csrc/rbf_gram.cu: kMaxD


def _check(name: str, a: torch.Tensor, ndim: int) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"rbf_gram: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"rbf_gram: {name} must be float32, got {a.dtype}")
    if a.dim() != ndim or not a.is_contiguous():
        raise ValueError(
            f"rbf_gram: {name} must be a contiguous {ndim}-D tensor, "
            f"got shape {tuple(a.shape)}"
        )


def rbf_gram_cuda(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    """x (b, n, d), y (b, m, d) float32 CUDA -> (b, n, m) float32."""
    _check("x", x, 3)
    _check("y", y, 3)
    b, n, d = x.shape
    if y.shape[0] != b or y.shape[2] != d or y.device != x.device:
        raise ValueError(
            f"rbf_gram: x {tuple(x.shape)} and y {tuple(y.shape)} disagree"
        )
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rbf_gram: feature dim {d} outside 1..{MAX_D}")
    m = y.shape[1]
    out = torch.empty((b, n, m), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    _build.launch(
        "rbf_gram", "rbf_gram_launch",
        x.data_ptr(), y.data_ptr(), out.data_ptr(), b, n, m, d,
        float(-gamma), dev, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
