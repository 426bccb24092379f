"""Wrapper of the Hopper SSD intra-chunk kernel (``csrc/ssd_scan.cu``).

For every (b·h, chunk): y_intra, the chunk's input state, C ⊙ exp(a_cum)
and the chunk's total decay, with B and C read per group. The plain
version is ``ref.ssd_chunks_ref``; ``ops.ssd_chunks`` dispatches and
``ops.ssd_scan_chunked`` runs the recurrence around it.

A block of the kernel runs ``head_slice`` heads of one group on one
(batch row, chunk): it stages B and C and computes C Bᵀ once for them.
``head_slice`` picks that count from the shapes and the card's SM count;
it is a pure function, so the host tests check it.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

MAX_T, MAX_N, MAX_P = 128, 128, 64  # csrc/ssd_scan.cu: kMaxT, kMaxN, kMaxP
MAX_HEAD_SLICE = 32  # kMaxHeadSlice
MAX_BLOCKS = 2**31 - 1  # the grid's x extent
H100_SMS = 132
# a block's own cost (staging B and C, C B^T) in units of one head's work
# (y_intra, the state, c_decay): 13 us against 22 us a head at mamba2-130m's
# shape on the H100 (phase timings from %globaltimer in the kernel)
BLOCK_COST_IN_HEADS = 0.6


def head_slice(blocks_per_head: int, per_group: int, sms: int = H100_SMS) -> int:
    """Heads of one group a block takes: the count that minimises waves ×
    (a block's own cost + its heads), where ``blocks_per_head`` = b·nc·g
    blocks run each head slice and ``sms`` blocks run at a time (one an
    SM). The smallest such count on a tie."""
    best, best_cost = 1, math.inf
    for heads in range(1, min(per_group, MAX_HEAD_SLICE) + 1):
        blocks = blocks_per_head * -(-per_group // heads)
        cost = -(-blocks // sms) * (BLOCK_COST_IN_HEADS + heads)
        if cost < best_cost:
            best, best_cost = heads, cost
    return best


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, a: torch.Tensor, shape) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"ssd_chunks: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"ssd_chunks: {name} must be float32, got {a.dtype}")
    if tuple(a.shape) != tuple(shape) or not a.is_contiguous():
        raise ValueError(
            f"ssd_chunks: {name} must be contiguous with shape {tuple(shape)}, "
            f"got {tuple(a.shape)}"
        )


def ssd_chunks_cuda(x, dt, a, B, C, *, heads: int):
    """x (bh, nc, T, p), dt and a (bh, nc, T), B and C (b, nc*T, g, n), all
    f32 CUDA -> (y_intra (bh, nc, T, p), states (bh, nc, n, p),
    c_decay (bh, nc, T, n), chunk_decay (bh, nc, 1, 1))."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(
            f"ssd_chunks: x {tuple(x.shape)} and B {tuple(B.shape)} must be 4-D")
    bh, nc, T, p = x.shape
    b, S, g, n = B.shape
    _check("x", x, (bh, nc, T, p))
    _check("dt", dt, (bh, nc, T))
    _check("a", a, (bh, nc, T))
    _check("B", B, (b, nc * T, g, n))
    _check("C", C, (b, nc * T, g, n))
    if len({x.device, dt.device, a.device, B.device, C.device}) != 1:
        raise ValueError("ssd_chunks: inputs on different devices")
    if heads < 1 or heads % g or b * heads != bh:
        raise ValueError(f"ssd_chunks: {heads} heads, {g} groups, b {b}, b*h {bh}")
    if not (1 <= T <= MAX_T and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(
            f"ssd_chunks: chunk {T}, state {n}, head dim {p} outside "
            f"{MAX_T}, {MAX_N}, {MAX_P}")
    dev = x.device
    y = torch.empty((bh, nc, T, p), dtype=torch.float32, device=dev)
    states = torch.empty((bh, nc, n, p), dtype=torch.float32, device=dev)
    c_decay = torch.empty((bh, nc, T, n), dtype=torch.float32, device=dev)
    chunk_decay = torch.empty((bh, nc, 1, 1), dtype=torch.float32, device=dev)
    if nc == 0:
        return y, states, c_decay, chunk_decay
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_group = heads // g
    slice_heads = head_slice(b * nc * g, per_group, _sm_count(index))
    if b * nc * g * -(-per_group // slice_heads) > MAX_BLOCKS:
        raise ValueError(f"ssd_chunks: more than {MAX_BLOCKS} blocks")
    _build.launch(
        "ssd_chunks", "ssd_chunks_launch",
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), states.data_ptr(), c_decay.data_ptr(), chunk_decay.data_ptr(),
        b, heads, g, nc, T, p, n, slice_heads, index,
        torch.cuda.current_stream(index).cuda_stream,
    )
    return y, states, c_decay, chunk_decay
