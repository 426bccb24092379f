"""int8 error-feedback gradient compression over a data-parallel group,
the reference's ``optim/compress.py`` on ``torch.distributed``.

``compressed_psum`` is an int8 reduce-scatter / all-gather pair over a
process group (the reference's ``shard_map`` axis name becomes a
``torch.distributed`` group):

  1. pad the flat tensor and split it into one 256-aligned chunk per rank,
  2. quantize every chunk blockwise to int8 (the Hopper codec on the card),
  3. ``all_to_all_single`` the int8 chunks and their f32 scales,
  4. dequantize the senders' chunks and sum them (plain torch, as the
     reference does in jnp) -> this rank's reduced chunk,
  5. re-quantize it, ``all_gather_into_tensor``, dequantize.

``compressed_grad_tree`` adds the error feedback: g_eff = g + residual,
the wire carries Q(g_eff), and the new residual is g_eff - Q(g_eff),
measured against the LOCAL quantization. Per tensor that is three
``int8_quantize`` launches and one ``int8_dequantize`` launch. Every
tensor is compressed on its own (never one concatenated buffer: block
boundaries would move, and starcoder2-3b's 3.03e9 elements overflow a
32-bit count).

Unlike the reference, which returns new trees, ``compressed_grad_tree``
writes the reduced gradients into the gradient tensors and the new
residuals into the residual tensors, in place (a full-width model has no
room for second copies).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops

BLOCK = 256


def _quant_chunks(x2d: torch.Tensor, impl):
    """x2d (n_dev, chunk) -> (q int8 (n_dev, chunk), scales (n_dev, nb))."""
    n_dev, chunk = x2d.shape
    q, s = ops.int8_quantize(x2d.reshape(-1), block=BLOCK, impl=impl)
    return q.reshape(n_dev, chunk), s.reshape(n_dev, chunk // BLOCK)


def compressed_psum(x: torch.Tensor, group=None, *, impl: Optional[str] = None):
    """Sum ``x`` (any shape) over ``group``'s ranks with an int8 wire format.
    Returns the summed tensor, in x's shape and dtype."""
    n_dev = dist.get_world_size(group)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    chunk = -(-n // (n_dev * BLOCK)) * BLOCK  # per-rank chunk, BLOCK-aligned
    if chunk * n_dev != n:
        flat = torch.nn.functional.pad(flat, (0, chunk * n_dev - n))
    q, s = _quant_chunks(flat.reshape(n_dev, chunk), impl)
    # reduce-scatter: rank i receives chunk i from every rank (int8 + scales)
    q_rs, s_rs = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_rs, q, group=group)
    dist.all_to_all_single(s_rs, s, group=group)
    local_sum = (q_rs.to(torch.float32).view(n_dev, chunk // BLOCK, BLOCK)
                 * s_rs[..., None]).sum(0).reshape(-1)
    # all-gather the reduced chunks in int8
    q2, s2 = ops.int8_quantize(local_sum, block=BLOCK, impl=impl)
    qg = torch.empty((n_dev * chunk,), dtype=torch.int8, device=x.device)
    sg = torch.empty((n_dev * (chunk // BLOCK),), dtype=torch.float32, device=x.device)
    dist.all_gather_into_tensor(qg, q2, group=group)  # gloo takes flat outputs only
    dist.all_gather_into_tensor(sg, s2, group=group)
    out = (qg.to(torch.float32).reshape(n_dev, chunk // BLOCK, BLOCK)
           * sg.view(n_dev, chunk // BLOCK)[..., None]).reshape(-1)[:n]
    return out.reshape(orig_shape).to(orig_dtype)


@torch.no_grad()
def compressed_grad_tree(grads: Dict[str, torch.Tensor], residuals: Dict[str, torch.Tensor],
                         group=None, *, impl: Optional[str] = None):
    """Error-feedback compressed mean of ``grads`` over ``group``, IN PLACE:
    each gradient becomes the group's mean (in its dtype) and each residual
    the local quantization error. Returns (grads, residuals)."""
    n_dev = dist.get_world_size(group)
    for name, g in grads.items():
        r = residuals[name]
        flat = (g.to(torch.float32) + r).reshape(-1)
        n = flat.numel()
        q, s = ops.int8_quantize(flat, block=BLOCK, impl=impl)
        deq = ops.int8_dequantize(q, s, n=n, block=BLOCK, impl=impl)
        r.view(-1).copy_(flat - deq)
        reduced = compressed_psum(deq.reshape(g.shape), group, impl=impl)
        g.copy_(reduced * (1.0 / n_dev))  # the reference's "/ n_dev", as XLA compiles it
    return grads, residuals


def init_residuals(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
