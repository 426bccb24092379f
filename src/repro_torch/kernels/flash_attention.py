"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Attention of q (b, h, sq, d) over k, v (b, hk, skv, d) with grouped-query
heads read by index (query head i reads kv head i // (h // hk)), causal,
sliding-window and ``kv_len`` masks, and queries at positions
``q_offset .. q_offset + sq``. ``kv_len`` and ``q_offset`` are launch
arguments, so decode steps launch the kernel too. With ``return_lse`` it
also returns the log-sum-exp of every row, which the backward recomputes
the probabilities from. The plain version is ``ref.flash_attention_ref``;
``ops.flash_attention`` dispatches.

``launch_plan`` says which of the kernel's paths a call takes, with its
tiles, key splits and scratch; it is a pure function of the shapes, so the
host tests check it. Head dims 16, 32, 64, 128 and 256 have kernel
instances; 96 and 112 are zero-padded to 128, 224 (Zamba2-7B's shared
blocks) to 256, and a batch with b*h above
65,535 runs as several launches of whole batch rows.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)  # csrc/flash_attention.cu: flash_attention_launch
# head dims the wrapper zero-pads to a kernel instance: zero columns add
# nothing to q k^T, give zero output columns, and are cut off again
PADDED_HEAD_DIMS = {96: 128, 112: 128, 224: 256}
DTYPES = (torch.float32, torch.bfloat16)
# b*h of one launch (the f32 kernels' grid y, the decode grid's z holds
# b*hk): the wrapper cuts a larger batch into launches of at most this
MAX_LAUNCH_BATCH_HEADS = 65535
DECODE_BELOW_SQ = 16  # kDecodeBelowSq
MMA_TILE_Q, MMA_TILE_K = 64, 64  # the bf16 tile kernel: one warpgroup's rows, keys a tile
DECODE_TILE_K = 64  # kDecTileK
FMA_TILE_Q, FMA_TILE_K = 64, 32  # the f32 tile kernel (keys a tile halved above d 128)
H100_SMS = 132


@dataclass(frozen=True)
class LaunchPlan:
    """One call's path through ``csrc/flash_attention.cu``.

    ``path``: "mma_tile" (bf16, sq >= 16: wgmma on the tensor cores),
    "mma_decode" (bf16, sq < 16: the query rows of a kv group packed into
    one mma.sync tile, keys split over blocks, then a merge), "fma_tile" /
    "fma_row" (f32). ``rows`` is the query rows a block takes (packed rows
    of a kv group on the decode path), ``tile_k`` the keys a tile,
    ``splits`` the key splits, ``scratch_shape`` the f32 partials (b, hk,
    packed rows, splits, d + 2) of the decode path, () elsewhere.
    """

    path: str
    rows: int
    tile_k: int
    splits: int
    scratch_shape: Tuple[int, ...]


def launch_plan(b: int, h: int, hk: int, sq: int, skv: int, d: int, dtype,
                kv_len: Optional[int] = None, sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's path for these shapes (``kv_len`` defaults to ``skv``;
    ``sms`` is the card's SM count)."""
    kv_len = skv if kv_len is None else kv_len
    if dtype == torch.float32:
        if sq < DECODE_BELOW_SQ:
            return LaunchPlan("fma_row", 1, 1, 1, ())
        return LaunchPlan("fma_tile", FMA_TILE_Q, FMA_TILE_K if d <= 128 else FMA_TILE_K // 2,
                          1, ())
    if sq >= DECODE_BELOW_SQ:
        return LaunchPlan("mma_tile", MMA_TILE_Q, MMA_TILE_K, 1, ())
    packed = (h // hk) * sq
    # at d 256 a block takes at most 32 rows (64 would spill registers)
    rows = 16 if packed <= 16 else 32 if packed <= 32 or d > 128 else 64
    key_tiles = max(1, math.ceil(kv_len / DECODE_TILE_K))
    # at least two blocks an SM where the cache has that many key tiles
    splits = max(1, min(key_tiles, math.ceil(2 * sms / (b * hk))))
    return LaunchPlan("mma_decode", rows, DECODE_TILE_K, splits,
                      (b, hk, packed, splits, d + 2))


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    q_offset: int, kv_len: Optional[int], return_lse: bool = False,
):
    """q (b, h, sq, d), k/v (b, hk, skv, d), f32 or bf16 CUDA -> out (b, h,
    sq, d) in q's dtype, or (out, lse (b, h, sq) f32, -inf for a fully
    masked row) with ``return_lse``."""
    d = q.shape[-1]
    if d not in HEAD_DIMS and d not in PADDED_HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {d} not in {HEAD_DIMS} or {tuple(PADDED_HEAD_DIMS)}")
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
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if d in PADDED_HEAD_DIMS:
        scale = 1.0 / (d**0.5) if scale is None else float(scale)
        width = PADDED_HEAD_DIMS[d] - d
        padded = [torch.nn.functional.pad(t, (0, width)) for t in (q, k, v)]
        res = flash_attention_cuda(*padded, scale=scale, return_lse=return_lse, **kw)
        out = (res[0] if return_lse else res)[..., :d].contiguous()
        return (out, res[1]) if return_lse else out
    if h > MAX_LAUNCH_BATCH_HEADS:
        raise ValueError(f"flash_attention: {h} heads > {MAX_LAUNCH_BATCH_HEADS}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside 0..{skv}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0 or skv == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    scale = 1.0 / (d**0.5) if scale is None else float(scale)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    rows = MAX_LAUNCH_BATCH_HEADS // h  # batch rows a launch
    for b0 in range(0, b, rows):
        part = slice(b0, min(b, b0 + rows))
        _launch(q[part], k[part], v[part], out[part], None if lse is None else lse[part],
                scale=scale, causal=causal, window=window, kv_len=kv_len,
                q_offset=q_offset, dev=dev)
    return (out, lse) if return_lse else out


def _launch(q, k, v, out, lse, *, scale, causal, window, kv_len, q_offset, dev) -> None:
    """One launch over whole batch rows: contiguous slices of dim 0."""
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    plan = launch_plan(b, h, hk, sq, skv, d, q.dtype, kv_len, _sm_count(dev))
    scratch = (torch.empty(plan.scratch_shape, dtype=torch.float32, device=q.device)
               if plan.scratch_shape else None)
    _build.launch(
        "flash_attention", "flash_attention_launch",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(),
        b, h, hk, sq, skv, d, int(q.dtype == torch.bfloat16), scale, int(bool(causal)),
        0 if window is None else int(window), kv_len, int(q_offset), plan.splits,
        dev, torch.cuda.current_stream(dev).cuda_stream,
    )
