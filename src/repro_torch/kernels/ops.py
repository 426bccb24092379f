"""Public kernel entry points, with device dispatch.

Dispatch follows the tensor, with no environment variable and no
fallback:

* a CPU tensor goes to the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor goes to the Hopper kernel, which launches or raises;
* ``impl="ref"`` runs the plain version on any device (the tests and
  ``chip_smoke.py`` hold the kernels against it).

``LAUNCHES`` counts the kernel launches, one per call that reached a
kernel; ``reset_launches()`` sets every count to 0.

Gradients: ``flash_attention`` and ``ssd_scan`` run inside a
``torch.autograd.Function``, as the reference's ``_flash_vjp`` /
``_ssd_vjp``: the forward is the kernel (CUDA) or the plain version (CPU,
``impl="ref"``). On the card, bf16 at a head dim the backward kernel takes
(``attention_bwd.takes``: 16 to 128) saves the forward's (out, lse)
beside the inputs and runs the Hopper backward (``csrc/attention_bwd.cu``);
every other call saves only the inputs, recomputes (out, lse) through the
forward's dispatch and runs the plain chunked backward, as the reference
does. On the card the SSD forward also saves the chunks' entry states and
the backward is the Hopper kernel pair (``csrc/ssd_bwd.cu``); on the host
and under ``impl="ref"`` it is the VJP of the plain scan. Where no input
needs a gradient (serving), the Function only runs its forward. Under a recorder
(``repro_torch.obs``) each backward is a span, ``attention.bwd`` or
``ssd.bwd``. The other kernels stay
forward-only, as the reference's do. A kernel
launched through ctypes into ``torch.empty`` outputs has no ``grad_fn``:
called bare under autograd it would leave every weight before it without
a gradient, and no error.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import _build, attention_bwd, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.int8_codec import int8_dequantize_cuda, int8_quantize_cuda
from repro_torch.kernels.plan_grid import pareto_mask_cuda, plan_argmin_cuda
from repro_torch.kernels.rbf_gram import rbf_gram_cuda
from repro_torch.kernels.ssd_bwd import ssd_bwd_cuda
from repro_torch.kernels.ssd_scan import ssd_chunks_cuda

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

IMPLS = (None, "ref")


def use_kernel(a: torch.Tensor, impl: Optional[str] = None) -> bool:
    """True when ``a``'s call goes to the Hopper kernel."""
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; want one of {IMPLS}")
    if impl == "ref":
        return False
    if a.device.type == "cuda":
        return True
    if a.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel for tensors on {a.device}")


def rbf_gram(x: torch.Tensor, y: torch.Tensor, gamma: float, *,
             impl: Optional[str] = None) -> torch.Tensor:
    """K[i,j] = exp(-gamma ||x_i - y_j||^2); x (n,d), y (m,d) -> (n,m) f32.

    Also accepts a batch dim — x (b,n,d), y (b,m,d) -> (b,n,m) — so one
    call builds many Gram blocks (``svr.predict_many`` / ``fit_many``).
    """
    if not use_kernel(x, impl):
        return ref.rbf_gram_ref(x, y, gamma)
    batched = x.dim() == 3
    x3 = x.to(torch.float32).contiguous()
    y3 = y.to(torch.float32).contiguous()
    if not batched:
        x3, y3 = x3[None], y3[None]
    out = rbf_gram_cuda(x3, y3, float(gamma))
    return out if batched else out[0]


def plan_argmin(t, w, k, mask, *, time_floor: float,
                impl: Optional[str] = None) -> torch.Tensor:
    """Masked objective argmin per row; t (B, G), w (G,)/(1, G), k (B,),
    mask (B, G) -> (B,) int32 first-minimum flat indices.

    The metric is (W·T)·T^k with T floored, in the engine's exact-path
    expression order, so the fused and exact paths pick the same configs.
    """
    t = t.to(torch.float32).contiguous()
    w2 = w.to(torch.float32).reshape(1, -1).contiguous()
    k = k.to(torch.float32).contiguous()
    m = (mask if mask.dtype == torch.bool else mask > 0).contiguous()
    if not use_kernel(t, impl):
        return ref.plan_argmin_ref(t, w2, k, m, time_floor=time_floor)
    return plan_argmin_cuda(t, w2, k, m, time_floor=time_floor)


def pareto_mask(t, e, mask, *, impl: Optional[str] = None) -> torch.Tensor:
    """Pareto keep-set per row; t, e, mask (B, G) -> (B, G) bool.

    Same dominance semantics and flat-index tie-break as the host
    ``engine.pareto_frontier`` sweep; masked or non-finite points never
    survive.
    """
    t = t.to(torch.float32).contiguous()
    e = e.to(torch.float32).contiguous()
    m = (mask if mask.dtype == torch.bool else mask > 0).contiguous()
    if not use_kernel(t, impl):
        return ref.pareto_mask_ref(t, e, m)
    return pareto_mask_cuda(t, e, m)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None, impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention, GQA-aware: q (b, h, sq, d), k/v (b, hk, skv, d)
    -> (b, h, sq, d) in q's dtype.

    ``q_offset`` and ``kv_len`` are plain ints (the host knows a decode
    step's position), so on the card prefill and decode both launch the
    kernel.
    """
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset, kv_len=kv_len)
    # the backward kernel's residuals are saved only where a backward can run
    kernel_bwd = (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
                  and use_kernel(q, impl) and attention_bwd.takes(q))
    return _FlashAttention.apply(q, k, v, kw, impl, kernel_bwd)


def flash_attention_lse(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_offset: int = 0,
                        kv_len: Optional[int] = None, impl: Optional[str] = None):
    """``flash_attention`` and its log-sum-exp (b, h, sq) f32, forward
    only (decode over a cache split by sequence merges the ranks' parts by
    it)."""
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset, kv_len=kv_len)
    return _flash_forward(q, k, v, kw, impl, return_lse=True)


_PLAIN_BLOCKS: dict = {}


@contextlib.contextmanager
def plain_attention_blocks(block_q: int, block_k: int):
    """Within the block, the plain attention (forward and backward) runs
    with query and key blocks of these sizes, in place of
    ``ref.flash_attention_ref``'s 512: the same products and score
    elements, with fewer blocks to step through (the dry run's trace uses
    one block each way)."""
    prev = dict(_PLAIN_BLOCKS)
    _PLAIN_BLOCKS.update(block_q=block_q, block_k=block_k)
    try:
        yield
    finally:
        _PLAIN_BLOCKS.clear()
        _PLAIN_BLOCKS.update(prev)


def _flash_forward(q, k, v, kw, impl, return_lse=False):
    if not use_kernel(q, impl):
        return ref.flash_attention_ref(q, k, v, return_lse=return_lse, **kw, **_PLAIN_BLOCKS)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                return_lse=return_lse, **kw)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel or the plain version. With ``kernel_bwd`` (set
    by ``flash_attention`` where grad mode is on, an input needs a gradient
    and the Hopper backward takes the call: a CUDA tensor, not
    ``impl="ref"``, bf16, head dim 16 to 128, ``attention_bwd.takes``) the
    forward also returns lse and saves (q, k, v, out, lse), and the
    backward is that kernel. Otherwise (f32, head dim 256, the host, the
    plain arm) it saves (q, k, v), and the backward recomputes (out, lse)
    through the forward's dispatch and runs the plain chunked backward
    (``ref.flash_attention_bwd_ref``), the reference's algorithm."""

    @staticmethod
    def forward(ctx, q, k, v, kw, impl, kernel_bwd=False):
        ctx.kw, ctx.impl, ctx.kernel_bwd = kw, impl, kernel_bwd
        if not kernel_bwd:
            ctx.save_for_backward(q, k, v)
            return _flash_forward(q, k, v, kw, impl)
        out, lse = _flash_forward(q, k, v, kw, impl, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        with obs.span("attention.bwd", cat="train"):
            saved = ctx.saved_tensors  # once: a checkpoint unpacks each tensor once
            q, k, v = saved[:3]
            g = g.to(q.dtype)
            if ctx.kernel_bwd:
                dq, dk, dv = attention_bwd.attention_bwd_cuda(
                    q.contiguous(), k.contiguous(), v.contiguous(), *saved[3:], g.contiguous(),
                    **ctx.kw)
            else:
                out, lse = _flash_forward(q, k, v, ctx.kw, ctx.impl, return_lse=True)
                dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, g,
                                                         **ctx.kw, **_PLAIN_BLOCKS)
        return dq, dk, dv, None, None, None


def ssd_chunks(x, dt, a, B, C, *, heads: int, impl: Optional[str] = None):
    """The SSD intra-chunk block of every (b·h, chunk); see
    ``ref.ssd_chunks_ref`` for the shapes and outputs."""
    if not use_kernel(x, impl):
        return ref.ssd_chunks_ref(x, dt, a, B, C, heads=heads)
    return ssd_chunks_cuda(x, dt, a, B, C, heads=heads)


def _per_chunk(t, chunk: int):
    """(b, s, h, ...) -> (b·h, nc, chunk, ...) f32 contiguous, s zero-padded
    to a multiple of ``chunk``."""
    b, s, h = t.shape[:3]
    pad = (-s) % chunk
    if pad:
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    nc = t.shape[1] // chunk
    return t.movedim(2, 1).reshape(b * h, nc, chunk, *t.shape[3:]).float().contiguous()


def _chunk_layout(x, dt, A, B, C, chunk: int):
    """The chunk kernels' layout, as the reference's ``_ssd_pallas_impl``:
    x and dt per (b·h, chunk) (``_per_chunk``), a = dt·A with A tiled over
    the batch, B and C (b, nc·T, g, n) padded alike, all f32 contiguous."""
    b = x.shape[0]
    xc, dtc = _per_chunk(x, chunk), _per_chunk(dt, chunk)
    a = (dtc * A.float().repeat(b)[:, None, None]).contiguous()
    pad = (-B.shape[1]) % chunk
    if pad:
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    return xc, dtc, a, B.float().contiguous(), C.float().contiguous()


def ssd_scan_chunked(x, dt, A, B, C, *, chunk: int, h0=None, return_state: bool = False,
                     entry_states: bool = False):
    """Chunked SSD around ``ssd_chunks``, as the reference's
    ``_ssd_pallas_impl``: the chunk layout (``_chunk_layout``), the chunk
    block, then the inter-chunk recurrence (from ``h0`` (b, h, n, p), zeros
    when None) and the state-output product as torch ops. B and C stay (b,
    s, g, n): the chunk block reads them per group. ``entry_states`` also
    returns, last, the chunks' entry states (b·h, nc, n, p) f32, which the
    state-output product reads anyway (the backward kernel's input)."""
    b, s, h, p = x.shape
    n = B.shape[3]
    xc, dtc, a, Bf, Cf = _chunk_layout(x, dt, A, B, C, chunk)
    nc = xc.shape[1]
    y_intra, states, c_decay, chunk_decay = ssd_chunks(xc, dtc, a, Bf, Cf, heads=h)
    del Bf, Cf  # freed once read: serving holds no temporary longer than it must
    hprev = (torch.zeros((b * h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.reshape(b * h, n, p).float())
    h_prevs = []
    for c in range(nc):  # sequential over chunks, tiny
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, c] + states[:, c]
    H = torch.stack(h_prevs, dim=1)
    y_state = c_decay @ H  # (bh, nc, T, n) @ (bh, nc, n, p)
    if not entry_states:
        del H  # likewise, before the sum below
    y = (y_intra + y_state).reshape(b, h, nc * chunk, p).movedim(1, 2)[:, :s].to(x.dtype)
    out = (y, hprev.reshape(b, h, n, p)) if return_state else (y,)
    if entry_states:
        return (*out, H)
    return out if return_state else y


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, h0=None, return_state: bool = False,
             impl: Optional[str] = None):
    """Chunked Mamba2 SSD: x (b, s, h, p), dt (b, s, h), A (h,), B/C
    (b, s, g, n), initial state ``h0`` (b, h, n, p) or None (zeros) -> y
    (b, s, h, p) [, final state (b, h, n, p) f32].

    A CPU tensor or ``impl="ref"`` takes the plain ``ref.ssd_scan_ref``
    (where the reference routes its jnp oracle); a CUDA tensor takes
    ``ssd_scan_chunked`` around the Hopper chunk kernel, with or without
    ``h0``, and its backward the Hopper backward (``ssd_bwd.ssd_bwd_cuda``).
    """
    # the backward kernel's input (the chunks' entry states) is saved only
    # where a backward can run
    kernel_bwd = (torch.is_grad_enabled() and use_kernel(x, impl)
                  and any(t is not None and t.requires_grad for t in (x, dt, A, B, C, h0)))
    return _SSDScan.apply(x, dt, A, B, C, h0, chunk, return_state, impl, kernel_bwd)


class _SSDScan(torch.autograd.Function):
    """Forward: the chunk kernel's scan or the plain version. With
    ``kernel_bwd`` (set by ``ssd_scan`` where grad mode is on, an input
    needs a gradient and the call runs on the card) the forward also saves
    the chunks' entry states beside the inputs, and the backward is the
    Hopper kernel pair (``ssd_bwd.ssd_bwd_cuda``). Otherwise (the host,
    ``impl="ref"``) it saves the inputs (``h0`` too) and the backward is the
    VJP of the plain ``ssd_scan_ref``, recomputed. Without a gradient
    (serving) the forward runs the same launches and ops either way."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk, return_state, impl, kernel_bwd=False):
        ctx.chunk, ctx.return_state, ctx.kernel_bwd = chunk, return_state, kernel_bwd
        kw = dict(chunk=chunk, h0=h0, return_state=return_state)
        if not use_kernel(x, impl):
            ctx.save_for_backward(x, dt, A, B, C, h0)
            return ref.ssd_scan_ref(x, dt, A, B, C, **kw)
        if not kernel_bwd:
            ctx.save_for_backward(x, dt, A, B, C, h0)
            return ssd_scan_chunked(x, dt, A, B, C, **kw)
        *out, H = ssd_scan_chunked(x, dt, A, B, C, entry_states=True, **kw)
        ctx.save_for_backward(x, dt, A, B, C, h0, H)
        return tuple(out) if return_state else out[0]

    @staticmethod
    def backward(ctx, *grads):
        with obs.span("ssd.bwd", cat="train"):
            saved = ctx.saved_tensors  # once: a checkpoint unpacks each tensor once
            if ctx.kernel_bwd:
                d = _ssd_kernel_backward(saved, grads, ctx.chunk, ctx.return_state)
                return (*d, None, None, None, None)
            inputs = [None if t is None else t.detach().requires_grad_(True) for t in saved]
            with torch.enable_grad():
                out = ref.ssd_scan_ref(*inputs[:5], chunk=ctx.chunk, h0=inputs[5],
                                       return_state=ctx.return_state)
            outs = out if ctx.return_state else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [t for t in inputs if t is not None]
            d = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True))
            return (*(None if t is None else next(d) for t in inputs), None, None, None, None)


def _ssd_kernel_backward(saved, grads, chunk: int, return_state: bool):
    """dx, ddt, dA, dB, dC and d h0 of ``ssd_scan_chunked`` by the Hopper
    backward, in the inputs' layouts and dtypes (d h0 None without h0)."""
    x, dt, A, B, C, h0, H = saved
    b, s, h, p = x.shape
    n = B.shape[3]
    xc, dtc, a, Bf, Cf = _chunk_layout(x, dt, A, B, C, chunk)
    nc = xc.shape[1]
    dyc = _per_chunk(grads[0] if grads[0] is not None else torch.zeros_like(x), chunk)
    d_final = grads[1] if return_state else None
    if d_final is not None:
        d_final = d_final.reshape(b * h, n, p).float().contiguous()
    dxc, ddtc, dA_part, dB, dC, dh0 = ssd_bwd_cuda(
        xc, dtc, a, A.float().repeat(b).contiguous(), Bf, Cf, H, dyc, d_final, heads=h)
    dx = dxc.reshape(b, h, nc * chunk, p).movedim(1, 2)[:, :s].to(x.dtype)
    ddt = ddtc.reshape(b, h, nc * chunk).movedim(1, 2)[:, :s].to(dt.dtype)
    dA = dA_part.reshape(b, h, nc).sum((0, 2)).to(A.dtype)
    dh0 = None if h0 is None else dh0.reshape(b, h, n, p).to(h0.dtype)
    return dx, ddt, dA, dB[:, :s].to(B.dtype), dC[:, :s].to(C.dtype), dh0


ssm_decode_step = ref.ssm_decode_step  # the recurrent step is plain torch, as in the reference


def int8_quantize(x: torch.Tensor, *, block: int = 256, impl: Optional[str] = None):
    """Blockwise symmetric int8: x (any shape, read flat, n elements) ->
    (q int8 (nb·block,), scales f32 (nb,)), nb = ceil(n/block); see
    ``ref.int8_quantize_ref``. The kernel takes block 256 only."""
    flat = x.reshape(-1)
    if not use_kernel(flat, impl):
        return ref.int8_quantize_ref(flat, block=block)
    return int8_quantize_cuda(flat.to(torch.float32).contiguous(), block=block)


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor, *, n: int, block: int = 256,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q·scale per block, cut to n: f32 (n,)."""
    if not use_kernel(q, impl):
        return ref.int8_dequantize_ref(q, scales, n, block=block)
    return int8_dequantize_cuda(q.contiguous(), scales.to(torch.float32).contiguous(),
                                n=n, block=block)
