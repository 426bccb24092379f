"""Wrapper of the Hopper attention backward (``csrc/attention_bwd.cu``).

dq, dk, dv of ``flash_attention`` from q, k, v, the forward's output and
its log-sum-exp, and the output's gradient, in bf16: the masks (causal or
bidirectional, ``window``, ``q_offset``, ``kv_len``) and grouped-query
heads of the forward. Head dims 16, 32, 64 and 128 have kernel instances;
96 and 112 are zero-padded to 128 (zero columns add nothing to q kᵀ or to
dO vᵀ, and their gradients are cut off). f32 inputs and d 256 have no
kernel: ``kernels/ops.py`` gives them the plain backward
(``ref.flash_attention_bwd_ref``), the same function.

One call is one count of ``LAUNCHES["attention_bwd"]``, whatever the
number of kernels it launches (a prep pass, the main kernel, the bf16
conversion).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)  # csrc/attention_bwd.cu: attention_bwd_launch
PADDED_HEAD_DIMS = {96: 128, 112: 128}
TILE = 64  # kTile: keys a block, query rows a step


def takes(q: torch.Tensor) -> bool:
    """True when the kernel computes this call's backward: bf16, a head dim
    it has (or pads to)."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and (d in HEAD_DIMS or d in PADDED_HEAD_DIMS)


def _check(name: str, a: torch.Tensor, dtype, dim: int) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"attention_bwd: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != dtype:
        raise ValueError(f"attention_bwd: {name} must be {dtype}, got {a.dtype}")
    if a.dim() != dim or not a.is_contiguous():
        raise ValueError(f"attention_bwd: {name} must be a contiguous {dim}-D tensor, "
                         f"got shape {tuple(a.shape)}")


def attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool, window: Optional[int],
                       scale: Optional[float], q_offset: int, kv_len: Optional[int]):
    """q, out, dout (b, h, sq, d), k, v (b, hk, skv, d) bf16 CUDA, lse (b, h,
    sq) f32 -> (dq, dk, dv) in bf16, shaped as q, k, v."""
    if not takes(q):
        raise ValueError(f"attention_bwd: {q.dtype} at head dim {q.shape[-1]} has no kernel "
                         f"(bf16 at {HEAD_DIMS} or {tuple(PADDED_HEAD_DIMS)})")
    for name, a in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        _check(name, a, torch.bfloat16, 4)
    _check("lse", lse, torch.float32, 3)
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if (k.shape[0] != b or k.shape[3] != d or tuple(v.shape) != tuple(k.shape)
            or tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape)
            or tuple(lse.shape) != (b, h, sq)):
        raise ValueError(f"attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out, dout and lse {tuple(lse.shape)} disagree")
    if hk < 1 or h % hk:
        raise ValueError(f"attention_bwd: {h} query heads over {hk} kv heads")
    scale = 1.0 / (d**0.5) if scale is None else float(scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if d in PADDED_HEAD_DIMS:
        width = PADDED_HEAD_DIMS[d] - d
        padded = [torch.nn.functional.pad(t, (0, width)) for t in (q, k, v, out, dout)]
        grads = attention_bwd_cuda(*padded[:4], lse, padded[4], scale=scale, **kw)
        return tuple(g[..., :d].contiguous() for g in grads)
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"attention_bwd: kv_len {kv_len} outside 0..{skv}")
    if q_offset < 0:
        raise ValueError(f"attention_bwd: q_offset {q_offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"attention_bwd: window {window} < 1")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    sq_pad = -(-sq // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=q.device)
    lse2 = torch.empty((b, h, sq_pad), **f32)
    delta = torch.empty((b, h, sq_pad), **f32)
    dq_acc = torch.zeros((b, h, sq, d), **f32)
    dk_acc = torch.zeros((b, hk, skv, d), **f32)
    dv_acc = torch.zeros((b, hk, skv, d), **f32)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    _build.launch(
        "attention_bwd", "attention_bwd_launch",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        dk_acc.data_ptr(), dv_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, hk, sq, skv, d, scale, int(bool(causal)), 0 if window is None else int(window),
        kv_len, int(q_offset), dev, torch.cuda.current_stream(dev).cuda_stream,
    )
    return dq, dk, dv
