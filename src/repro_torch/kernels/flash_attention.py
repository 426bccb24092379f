"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Attention of q (b, h, sq, d) over k, v (b, hk, skv, d) with grouped-query
heads read by index (query head i reads kv head i // (h // hk)), causal,
sliding-window and ``kv_len`` masks, and queries at positions
``q_offset .. q_offset + sq``. ``kv_len`` and ``q_offset`` are launch
arguments, so decode steps launch the kernel too. The plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` dispatches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # csrc/flash_attention.cu: launch_dim
DTYPES = (torch.float32, torch.bfloat16)
MAX_BATCH_HEADS = 65535  # the grid's y extent


def _check(name: str, a: torch.Tensor, dtype) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != dtype:
        raise ValueError(f"flash_attention: {name} must be {dtype}, got {a.dtype}")
    if a.dim() != 4 or not a.is_contiguous():
        raise ValueError(
            f"flash_attention: {name} must be a contiguous 4-D tensor, "
            f"got shape {tuple(a.shape)}"
        )


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool, window: Optional[int], scale: Optional[float],
    q_offset: int, kv_len: Optional[int],
) -> torch.Tensor:
    """q (b, h, sq, d), k/v (b, hk, skv, d), f32 or bf16 CUDA -> (b, h, sq, d)
    in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    _check("q", q, q.dtype)
    _check("k", k, q.dtype)
    _check("v", v, q.dtype)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape)
            or len({q.device, k.device, v.device}) != 1):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
            f"v {tuple(v.shape)} disagree"
        )
    if hk < 1 or h % hk:
        raise ValueError(f"flash_attention: {h} query heads over {hk} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: b*h = {b * h} > {MAX_BATCH_HEADS}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside 0..{skv}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    scale = 1.0 / (d**0.5) if scale is None else float(scale)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    _build.launch(
        "flash_attention", "flash_attention_launch",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hk, sq, skv, d, int(q.dtype == torch.bfloat16), scale, int(bool(causal)),
        0 if window is None else int(window), kv_len, int(q_offset),
        dev, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out
