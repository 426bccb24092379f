"""Wrappers of the Hopper planning-grid kernels (``csrc/plan_grid.cu``).

``plan_argmin_cuda``: per row, the first flat index of the masked minimum
of (w·t)·t^k with t floored, a warp a row on a persistent grid.
``pareto_mask_cuda``: per row, the Pareto keep-set of (t, e) over the
feasible points, by a per-row sort and running minimum up to
``PARETO_SORT_SLOTS[-1]`` points a row and by all pairs past it
(``pareto_plan``). The plain versions are ``ref.plan_argmin_ref`` /
``ref.pareto_mask_ref``; ``ops.py`` dispatches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

# csrc/plan_grid.cu: the sort kernel's instances, slots a row (32 a lane x 4..32)
PARETO_SORT_SLOTS = (128, 256, 512, 1024)


@dataclass(frozen=True)
class ParetoPlan:
    """One ``pareto_mask`` call's path through ``csrc/plan_grid.cu``:
    "sort" (a warp a row, ``slots`` >= G sort slots) or "pairs" (all
    pairs, a block a row; ``slots`` 0)."""

    path: str
    slots: int


def pareto_plan(b: int, g: int) -> ParetoPlan:
    """The path for a (B, G) call: the sort with the fewest slots that hold
    G, or all pairs past the sort's capacity."""
    for slots in PARETO_SORT_SLOTS:
        if g <= slots:
            return ParetoPlan("sort", slots)
    return ParetoPlan("pairs", 0)


def _check(fn: str, name: str, a: torch.Tensor, dtype, shape) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: {name} must be a CUDA tensor, got {a.device}")
    if a.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {a.dtype}")
    if tuple(a.shape) != tuple(shape) or not a.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be contiguous with shape {tuple(shape)}, "
            f"got {tuple(a.shape)}"
        )


def _device_and_stream(a: torch.Tensor):
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def plan_argmin_cuda(
    t: torch.Tensor, w: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
    *, time_floor: float,
) -> torch.Tensor:
    """t (B, G) f32, w (1, G) f32, k (B,) f32, mask (B, G) bool -> (B,) int32."""
    if t.dim() != 2:
        raise ValueError(f"plan_argmin: t must be (B, G), got {tuple(t.shape)}")
    b, g = t.shape
    _check("plan_argmin", "t", t, torch.float32, (b, g))
    _check("plan_argmin", "w", w, torch.float32, (1, g))
    _check("plan_argmin", "k", k, torch.float32, (b,))
    _check("plan_argmin", "mask", mask, torch.bool, (b, g))
    if len({t.device, w.device, k.device, mask.device}) != 1:
        raise ValueError("plan_argmin: inputs on different devices")
    out = torch.empty((b,), dtype=torch.int32, device=t.device)
    if b == 0 or g == 0:
        return out.zero_()
    dev, stream = _device_and_stream(t)
    _build.launch(
        "plan_argmin", "plan_argmin_launch",
        t.data_ptr(), w.data_ptr(), k.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, g, float(time_floor), dev, stream,
    )
    return out


def pareto_mask_cuda(
    t: torch.Tensor, e: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """t, e (B, G) f32, mask (B, G) bool -> (B, G) bool keep-set."""
    if t.dim() != 2:
        raise ValueError(f"pareto_mask: t must be (B, G), got {tuple(t.shape)}")
    b, g = t.shape
    _check("pareto_mask", "t", t, torch.float32, (b, g))
    _check("pareto_mask", "e", e, torch.float32, (b, g))
    _check("pareto_mask", "mask", mask, torch.bool, (b, g))
    if len({t.device, e.device, mask.device}) != 1:
        raise ValueError("pareto_mask: inputs on different devices")
    out = torch.empty((b, g), dtype=torch.bool, device=t.device)
    if out.numel() == 0:
        return out
    dev, stream = _device_and_stream(t)
    _build.launch(
        "pareto_mask", "pareto_mask_launch",
        t.data_ptr(), e.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, g, pareto_plan(b, g).slots, dev, stream,
    )
    return out
