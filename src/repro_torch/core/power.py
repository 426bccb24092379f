"""CMOS power model of the paper (Eq. 1-7) and its multi-linear fit.

    P(f, p, s) = p (c1 f^3 + c2 f) + c3 + c4 s            (Eq. 7)

with f the clock (GHz), p the number of active cores (chips, on a TPU
slice), and s the number of sockets (pods).

``PowerModel.__call__`` computes in float32, in one fixed operation order,
on one of two paths:

* torch tensors: on the tensor's device (the engine's (f, cores) grid);
* Python or numpy scalars and arrays: on the host in numpy float32. The
  node simulator calls the model once per simulated tick, and a device
  round trip there would make the governor loop crawl.

The fit is minimum-norm least squares on the basis [p f^3, p f, 1, s].
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

# Paper Eq. (9): fit for the 2x Xeon E5-2698v3 node, f in GHz, P in watts.
PAPER_COEFFS = (0.29, 0.97, 198.59, 9.18)


def _is_tensor(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """P(f, p, s) = p (c1 f^3 + c2 f) + c3 + c4 s."""

    c1: float
    c2: float
    c3: float
    c4: float

    def __call__(self, f, p, s):
        if _is_tensor(f, p, s):
            return self._on_device(f, p, s)
        # host path: every coefficient enters as float32 and every product
        # rounds to float32 in the order below. ``c4 * s`` is evaluated by
        # Python/numpy before the float32 cast, as the reference does for a
        # scalar or numpy socket count.
        f32 = np.float32
        f = np.asarray(f, f32)
        dyn = f32(self.c1) * (f * f * f) + f32(self.c2) * f
        return (
            np.asarray(p).astype(f32) * dyn
            + f32(self.c3)
            + np.asarray(self.c4 * s).astype(f32)
        )

    def _on_device(self, f, p, s):
        dev = next(x.device for x in (f, p, s) if isinstance(x, torch.Tensor))

        def as32(x):
            return torch.as_tensor(x, device=dev).to(torch.float32)

        f, p, s = as32(f), as32(p), as32(s)
        c1, c2, c3, c4 = (as32(c) for c in self.coeffs())
        return p * (c1 * (f * f * f) + c2 * f) + c3 + c4 * s

    def dynamic_parcel(self, f, p, s):
        """p(c1 f^3 + c2 f) + c4 s — everything that scales with activity."""
        f = np.asarray(f, np.float32)
        return (
            np.asarray(p).astype(np.float32)
            * (np.float32(self.c1) * (f * f * f) + np.float32(self.c2) * f)
            + np.float32(self.c4 * s)
        )

    def static_parcel(self):
        return self.c3

    def race_to_idle_expected(self, f_max: float, p_max: int, s_max: int) -> bool:
        """Paper §4.1: race-to-idle is optimal when even the maximal dynamic
        parcel stays below the static parcel."""
        return bool(self.dynamic_parcel(f_max, p_max, s_max) < self.static_parcel())

    def coeffs(self) -> tuple[float, float, float, float]:
        return (self.c1, self.c2, self.c3, self.c4)


def paper_power_model() -> PowerModel:
    return PowerModel(*PAPER_COEFFS)


def _design_matrix(f, p, s) -> np.ndarray:
    f = np.asarray(f, np.float32)
    p = np.asarray(p, np.float32)
    s = np.asarray(s, np.float32)
    return np.stack([p * (f * f * f), p * f, np.ones_like(f), s], axis=-1)


def fit_power_model(f, p, s, watts) -> PowerModel:
    """Fit Eq. (7) coefficients from (f, p, s) -> measured watts samples.

    Mirrors the paper §3.3: stress samples over the full (frequency x cores)
    grid, one least-squares solve. The solve is minimum-norm, because a
    single-socket node's sweep has s ≡ 1 and makes the [1, s] columns
    collinear; the minimum-norm split of c3/c4 still predicts exactly. It
    runs on the host in float64 with LAPACK's SVD-based ``gelsd`` driver:
    CUDA's ``lstsq`` offers only ``gels``, which assumes full rank.
    """
    X = torch.from_numpy(_design_matrix(f, p, s)).to(torch.float64)
    y = torch.from_numpy(np.asarray(watts, np.float32)).to(torch.float64)
    beta = torch.linalg.lstsq(X, y[:, None], driver="gelsd").solution[:, 0]
    c1, c2, c3, c4 = (float(np.float32(b)) for b in beta.tolist())
    return PowerModel(c1, c2, c3, c4)


def absolute_percentage_error(model: PowerModel, f, p, s, watts) -> float:
    """Paper Eq. (10): mean |y - y_model| / y."""
    pred = model(f, p, s)
    y = np.asarray(watts, np.float32)
    return float(np.mean(np.abs(y - pred) / y))


def rmse(model: PowerModel, f, p, s, watts) -> float:
    pred = model(f, p, s)
    y = np.asarray(watts, np.float32)
    return float(np.sqrt(np.mean((y - pred) ** 2)))


def fit_report(model: PowerModel, f, p, s, watts) -> Mapping[str, float]:
    return {
        "c1": model.c1,
        "c2": model.c2,
        "c3": model.c3,
        "c4": model.c4,
        "ape": absolute_percentage_error(model, f, p, s, watts),
        "rmse_watts": rmse(model, f, p, s, watts),
    }
