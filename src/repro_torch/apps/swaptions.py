"""Swaptions: HJM Monte-Carlo swaption pricing (PARSEC kernel in PyTorch).

Simulates forward-rate curve paths under a 3-factor Heath-Jarrow-Morton
model (deterministic drift from the HJM no-arbitrage condition, principal-
component volatility loadings as in the PARSEC original) and prices a
portfolio of payer swaptions by Monte Carlo, vectorized over
(swaptions × trials) with a loop over time steps.

The shocks come from a ``torch.Generator`` seeded from ``seed`` on the
run's device, so the prices agree with the JAX package's (whose draws are
``jax.random``'s) within their Monte-Carlo standard errors; ``simulate``
takes the shocks ``z`` to reproduce a given set of draws.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_N = 8  # number of swaptions; trials fixed per swaption
TRIALS = 512
TENORS = 20  # quarterly forward curve buckets (5y)
STEPS = 20  # simulation steps to option expiry
DT = 0.25
FACTORS = 3


def _vol_loadings():
    """Three PCA-style HJM factor loadings over the tenor axis."""
    tau = np.arange(TENORS) * DT
    f1 = 0.010 * np.ones_like(tau)  # level
    f2 = 0.006 * (1.0 - 2.0 * tau / tau.max())  # slope
    f3 = 0.004 * np.exp(-(((tau - tau.mean()) / (0.5 * tau.std() + 1e-9)) ** 2))
    return np.stack([f1, f2, f3], axis=0)  # (3, TENORS)


def make_inputs(n: int = DEFAULT_N, seed: int = 0, device: DeviceLike = None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fwd0 = 0.03 + 0.01 * np.sin(np.linspace(0, 2.0, TENORS))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return {
        "fwd0": f32(fwd0),
        "vols": f32(_vol_loadings()),
        "strikes": f32(rng.uniform(0.02, 0.05, n)),
        "seed": seed,
        "n": n,
    }


def simulate(fwd0, vols, strikes, n: int, seed: int = 0,
             z: Optional[torch.Tensor] = None):
    """(price, stderr) of ``n`` swaptions on ``fwd0``'s device. The
    (STEPS, n, TRIALS, FACTORS) standard-normal shocks are drawn from a
    generator seeded with ``seed`` on that device, unless ``z`` gives them."""
    dev = fwd0.device
    # HJM drift: mu(tau) = sigma(tau) * cumsum(sigma) * dt (discretized)
    drift = torch.sum(vols * torch.cumsum(vols, dim=1) * DT, dim=0)  # (TENORS,)
    if z is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        z = torch.randn((STEPS, n, TRIALS, FACTORS), generator=gen, device=dev)
    z = z.to(device=dev, dtype=torch.float32)
    sqrt_dt = math.sqrt(DT)

    fwd = fwd0.expand(n, TRIALS, TENORS)
    short = []
    for zt in z:
        # fwd: (n, TRIALS, TENORS); zt: (n, TRIALS, 3)
        shock = torch.einsum("ntk,kj->ntj", zt, vols) * sqrt_dt
        fwd = fwd + drift * DT + shock
        # roll down the curve: tenor 0 matures each step
        fwd = torch.cat([fwd[..., 1:], fwd[..., -1:]], dim=-1)
        short.append(fwd[..., 0])
    short_rates = torch.stack(short)
    # discount factor along each path from realized short rates
    df = torch.exp(-torch.sum(short_rates, dim=0) * DT)  # (n, TRIALS)
    # swap rate at expiry from the simulated curve
    disc = torch.exp(-torch.cumsum(fwd, dim=-1) * DT)
    annuity = torch.sum(disc, dim=-1) * DT
    swap_rate = (1.0 - disc[..., -1]) / torch.clamp_min(annuity, 1e-9)
    payoff = torch.clamp_min(swap_rate - strikes[:, None], 0.0) * annuity
    value = df * payoff
    price = torch.mean(value, dim=1)
    stderr = torch.std(value, dim=1, correction=0) / math.sqrt(TRIALS)
    return price, stderr


def run(inputs, device: DeviceLike = None):
    dev = resolve_device(device)
    price, stderr = simulate(
        inputs["fwd0"].to(dev), inputs["vols"].to(dev), inputs["strikes"].to(dev),
        int(inputs["n"]), int(inputs["seed"]),
    )
    return {"price": price, "stderr": stderr}


def flops(n: int) -> float:
    return 2.0 * n * TRIALS * STEPS * TENORS * 3  # factor-shock einsum dominates
