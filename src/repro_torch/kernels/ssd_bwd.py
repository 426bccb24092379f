"""Wrapper of the Hopper SSD backward (``csrc/ssd_bwd.cu``).

The gradients of ``ops.ssd_scan_chunked`` with respect to x, dt, A, B, C
and the initial state, in the chunked layout the forward runs: two
chunk-parallel kernels around the reverse scan over chunks, which runs here
as torch ops (the mirror of the forward's loop):

1. ``ssd_bwd_intra_kernel``: everything inside a chunk (dM = dY xᵀ, dx =
   Mᵀ dY, dS, the dM parts of d dt and d cum, dB and dC's dS parts) and
   Z_c = (C ∘ e^cum)ᵀ dY_c;
2. G_{nc-1} = d(final state) or 0, G_{c-1} = e^{cum_{T-1}} G_c + Z_c,
   d h0 = G_{-1}; and <G_c, H_c>, H_c the chunk's entry state;
3. ``ssd_bwd_state_kernel``: the state parts (dx += (B ∘ w) G, dB and dC's
   state parts, the y-state term of d cum); then ``ssd_bwd_finish_kernel``:
   d dt and a (b·h, chunk) part of dA from the reverse cumsum of d cum.

dB and dC come out as one partial a head slice (``ssd_scan.head_slice``,
the forward's), summed here in a fixed order, and dA's parts are summed by
the caller: nothing is summed by atomics, so the gradients repeat bit for
bit. The plain version is autograd through ``ref.ssd_scan_ref``
(``kernels/ops.py``).

One call is one count of ``LAUNCHES["ssd_bwd"]``, whatever the number of
kernels it launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import MAX_BLOCKS, MAX_N, MAX_P, MAX_T, _sm_count, head_slice


def _check(named) -> None:
    """(name, tensor, shape) triples: every dtype, shape and layout first,
    then every device, so that each fault is named on the host too."""
    for name, a, shape in named:
        if a.dtype != torch.float32:
            raise ValueError(f"ssd_bwd: {name} must be float32, got {a.dtype}")
        if tuple(a.shape) != tuple(shape) or not a.is_contiguous():
            raise ValueError(
                f"ssd_bwd: {name} must be contiguous with shape {tuple(shape)}, "
                f"got {tuple(a.shape)}")
    for name, a, _ in named:
        if a.device.type != "cuda":
            raise ValueError(f"ssd_bwd: {name} must be a CUDA tensor, got {a.device}")
    if len({a.device for _, a, _ in named}) != 1:
        raise ValueError("ssd_bwd: inputs on different devices")


def ssd_bwd_cuda(x, dt, a, A, B, C, H, dy, d_final, *, heads: int):
    """x and dy (bh, nc, T, p), dt and a = dt·A (bh, nc, T), A (bh,) the
    heads' rates tiled over the batch rows, B and C (b, nc*T, g, n), H
    (bh, nc, n, p) the chunks' entry states, d_final (bh, n, p) or None,
    all f32 CUDA -> (dx (bh, nc, T, p), ddt (bh, nc, T), dA_part (bh, nc),
    dB and dC (b, nc*T, g, n), dh0 (bh, n, p))."""
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_bwd: x {tuple(x.shape)} and B {tuple(B.shape)} must be 4-D")
    bh, nc, T, p = x.shape
    b, S, g, n = B.shape
    named = [("x", x, (bh, nc, T, p)), ("dt", dt, (bh, nc, T)), ("a", a, (bh, nc, T)),
             ("A", A, (bh,)), ("B", B, (b, nc * T, g, n)), ("C", C, (b, nc * T, g, n)),
             ("H", H, (bh, nc, n, p)), ("dy", dy, (bh, nc, T, p))]
    _check(named + ([] if d_final is None else [("d_final", d_final, (bh, n, p))]))
    if heads < 1 or heads % g or b * heads != bh:
        raise ValueError(f"ssd_bwd: {heads} heads, {g} groups, b {b}, b*h {bh}")
    if not (1 <= T <= MAX_T and 1 <= n <= MAX_N and 1 <= p <= MAX_P):
        raise ValueError(f"ssd_bwd: chunk {T}, state {n}, head dim {p} outside "
                         f"{MAX_T}, {MAX_N}, {MAX_P}")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_group = heads // g
    slice_heads = head_slice(b * nc * g, per_group, _sm_count(index))
    slices = -(-per_group // slice_heads)
    if b * nc * g * slices > MAX_BLOCKS:
        raise ValueError(f"ssd_bwd: more than {MAX_BLOCKS} blocks")
    stream = torch.cuda.current_stream(index).cuda_stream
    dims = (b, heads, g, nc, T, p, n, slice_heads, index, stream)

    dx, z = torch.empty_like(x), torch.empty_like(H)
    ddt, dcum = torch.empty_like(dt), torch.empty_like(dt)
    decay = torch.empty((bh, nc), **f32)
    dB_part = torch.empty((slices, b, nc * T, g, n), **f32)
    dC_part = torch.empty_like(dB_part)
    _build.launch(
        "ssd_bwd", "ssd_bwd_intra_launch",
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), z.data_ptr(), ddt.data_ptr(), dcum.data_ptr(), decay.data_ptr(),
        dB_part.data_ptr(), dC_part.data_ptr(), *dims)

    # the reverse scan over chunks: G[:, c] is the gradient of chunk c's exit state
    G = torch.empty_like(H)
    if d_final is None:
        G[:, nc - 1].zero_()
    else:
        G[:, nc - 1].copy_(d_final)
    for c in range(nc - 1, 0, -1):
        torch.addcmul(z[:, c], decay[:, c, None, None], G[:, c], out=G[:, c - 1])
    dh0 = torch.addcmul(z[:, 0], decay[:, 0, None, None], G[:, 0])
    gh = (G * H).sum((-2, -1))  # (bh, nc): the chunk decay's gradient over e^{cum_{T-1}}

    dw, dcy = torch.empty_like(dt), torch.empty_like(dt)  # the state kernel's row vectors
    dA_part = torch.empty((bh, nc), **f32)
    _build.launch(
        "ssd_bwd", "ssd_bwd_state_launch",
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        dy.data_ptr(), H.data_ptr(), G.data_ptr(), gh.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dcum.data_ptr(), dw.data_ptr(), dcy.data_ptr(), dA_part.data_ptr(),
        dB_part.data_ptr(), dC_part.data_ptr(), *dims, count=0)
    if slices == 1:
        return dx, ddt, dA_part, dB_part[0], dC_part[0], dh0
    return dx, ddt, dA_part, dB_part.sum(0), dC_part.sum(0), dh0
