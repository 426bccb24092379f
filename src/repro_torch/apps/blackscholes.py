"""Blackscholes: analytic European option pricing (PARSEC kernel in PyTorch).

Prices a portfolio of n options with the closed-form Black-Scholes formula
(the PARSEC benchmark evaluates the same formula via a polynomial CNDF
approximation; we use the same Abramowitz-Stegun 5-coefficient polynomial so
the arithmetic mix matches the original kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_N = 4096

_A = (0.31938153, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
_INV_SQRT_2PI = 0.3989422804014327


def _cndf(x: torch.Tensor) -> torch.Tensor:
    """Cumulative normal via the PARSEC polynomial approximation."""
    sign = x < 0
    ax = torch.abs(x)
    k = 1.0 / (1.0 + 0.2316419 * ax)
    poly = k * (_A[0] + k * (_A[1] + k * (_A[2] + k * (_A[3] + k * _A[4]))))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * ax * ax)
    cnd = 1.0 - pdf * poly
    return torch.where(sign, 1.0 - cnd, cnd)


def make_inputs(n: int = DEFAULT_N, seed: int = 0, device: DeviceLike = None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return {
        "spot": f32(rng.uniform(20.0, 120.0, n)),
        "strike": f32(rng.uniform(20.0, 120.0, n)),
        "rate": f32(rng.uniform(0.01, 0.06, n)),
        "vol": f32(rng.uniform(0.1, 0.6, n)),
        "tte": f32(rng.uniform(0.1, 2.0, n)),
        "is_call": torch.from_numpy(rng.integers(0, 2, n).astype(bool)).to(dev),
    }


def run(inputs, device: DeviceLike = None):
    dev = resolve_device(device)
    s, k = inputs["spot"].to(dev), inputs["strike"].to(dev)
    r, v, t = inputs["rate"].to(dev), inputs["vol"].to(dev), inputs["tte"].to(dev)
    sqrt_t = torch.sqrt(t)
    d1 = (torch.log(s / k) + (r + 0.5 * v * v) * t) / (v * sqrt_t)
    d2 = d1 - v * sqrt_t
    disc = k * torch.exp(-r * t)
    call = s * _cndf(d1) - disc * _cndf(d2)
    put = disc * _cndf(-d2) - s * _cndf(-d1)
    return {"price": torch.where(inputs["is_call"].to(dev), call, put)}


def flops(n: int) -> float:
    return 120.0 * n  # ~dozens of transcendental-expanded flops per option
