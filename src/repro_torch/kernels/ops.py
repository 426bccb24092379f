"""Public kernel entry points, with device dispatch.

Dispatch follows the tensor, with no environment variable and no
fallback:

* a CPU tensor goes to the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor goes to the Hopper kernel, which launches or raises;
* ``impl="ref"`` runs the plain version on any device (the tests and
  ``chip_smoke.py`` hold the kernels against it).

``LAUNCHES`` counts the kernel launches, one per call that reached a
kernel; ``reset_launches()`` sets every count to 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.plan_grid import pareto_mask_cuda, plan_argmin_cuda
from repro_torch.kernels.rbf_gram import rbf_gram_cuda

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
