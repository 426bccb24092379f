"""Wrappers of the Hopper int8 codec kernels (``csrc/int8_codec.cu``).

``int8_quantize_cuda``: a flat f32 vector of n elements -> (q int8
(nb·256,), scales f32 (nb,)), nb = ceil(n/256), the reference's
``int8_quantize_ref`` contract. ``int8_dequantize_cuda``: (q, scales) ->
f32 (n,). The plain versions are ``ref.int8_quantize_ref`` /
``ref.int8_dequantize_ref``; ``ops.py`` dispatches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BLOCK = 256  # csrc/int8_codec.cu: kBlock, one warp of 8 floats a lane


def _check(fn: str, name: str, a: torch.Tensor, dtype, numel: int) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {a.dtype}")
    if a.dim() != 1 or a.numel() != numel or not a.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous vector of {numel} elements, "
            f"got shape {tuple(a.shape)}")


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` itself when its data starts on 16 bytes (the kernels' vector
    loads and stores), else an aligned copy."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _device_and_stream(a: torch.Tensor):
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _check_block(fn: str, block: int) -> None:
    if block != BLOCK:
        raise ValueError(f"{fn}: the kernel's block is {BLOCK} elements, not {block}")


def int8_quantize_cuda(x: torch.Tensor, *, block: int = BLOCK):
    """x (n,) f32 CUDA -> (q int8 (nb·256,), scales f32 (nb,))."""
    _check_block("int8_quantize", block)
    n = x.numel()
    _check("int8_quantize", "x", x, torch.float32, n)
    nb = -(-n // BLOCK)
    q = torch.empty((nb * BLOCK,), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, scales
    x = _aligned(x)
    dev, stream = _device_and_stream(x)
    _build.launch("int8_quantize", "int8_quantize_launch",
                  x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, nb, dev, stream)
    return q, scales


def int8_dequantize_cuda(q: torch.Tensor, scales: torch.Tensor, *, n: int,
                         block: int = BLOCK) -> torch.Tensor:
    """q int8 (nb·256,), scales f32 (nb,) CUDA -> f32 (n,), n <= nb·256."""
    _check_block("int8_dequantize", block)
    nb = scales.numel()
    _check("int8_dequantize", "scales", scales, torch.float32, nb)
    _check("int8_dequantize", "q", q, torch.int8, nb * BLOCK)
    if q.device != scales.device:
        raise ValueError("int8_dequantize: q and scales on different devices")
    if not 0 <= n <= nb * BLOCK:
        raise ValueError(f"int8_dequantize: n {n} outside 0..{nb * BLOCK}")
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    q = _aligned(q)
    dev, stream = _device_and_stream(q)
    _build.launch("int8_dequantize", "int8_dequantize_launch",
                  q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, dev, stream)
    return out
