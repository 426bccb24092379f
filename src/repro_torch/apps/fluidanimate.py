"""Fluidanimate: smoothed-particle-hydrodynamics step (PARSEC kernel in PyTorch).

One SPH time step for an incompressible fluid (the PARSEC original animates
a box of fluid): density estimation with the poly6 kernel, pressure +
viscosity forces with the spiky/viscosity kernels, symplectic Euler
integration, and box-wall collisions. All-pairs interactions with a cutoff
mask (the original uses a cell grid; all-pairs keeps the step dense and is
exact for the same cutoff). Memory is O(n²): n = 8,192 holds a few
(n, n, 3) float32 temporaries of 0.8 GB each.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_N = 512

H = 0.10  # smoothing radius
REST_DENSITY = 1000.0
STIFFNESS = 3.0
VISCOSITY = 0.25
DT = 2e-4
G = (0.0, -9.8, 0.0)
BOX = 1.0
PMASS = REST_DENSITY * BOX**3 / 4096  # nominal particle mass


def make_inputs(n: int = DEFAULT_N, seed: int = 0, device: DeviceLike = None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(
        np.meshgrid(*([np.linspace(0.1, 0.5, side)] * 3), indexing="ij"), -1
    ).reshape(-1, 3)[:n]
    pos = grid + rng.normal(0, 0.005, (n, 3))
    vel = np.zeros((n, 3))
    return {
        "pos": torch.from_numpy(pos.astype(np.float32)).to(dev),
        "vel": torch.from_numpy(vel.astype(np.float32)).to(dev),
    }


def run(inputs, device: DeviceLike = None):
    dev = resolve_device(device)
    pos, vel = inputs["pos"].to(dev), inputs["vel"].to(dev)
    n = pos.shape[0]
    diff = pos[:, None, :] - pos[None, :, :]  # (n, n, 3)
    r2 = torch.sum(diff * diff, dim=-1)
    h2 = H * H
    within = (r2 < h2) & ~torch.eye(n, dtype=torch.bool, device=dev)

    # density: poly6 kernel  W = 315/(64 pi h^9) (h^2 - r^2)^3
    w_poly6 = 315.0 / (64.0 * math.pi * H**9)
    dens_pair = torch.where(within, (h2 - r2) ** 3, 0.0)
    density = PMASS * w_poly6 * (torch.sum(dens_pair, dim=1) + h2**3)  # self term

    pressure = STIFFNESS * (density - REST_DENSITY)

    r = torch.sqrt(torch.clamp_min(r2, 1e-12))
    # pressure force: spiky gradient  45/(pi h^6) (h - r)^2
    w_spiky = 45.0 / (math.pi * H**6)
    pterm = torch.where(
        within,
        -PMASS
        * (pressure[:, None] + pressure[None, :])
        / (2.0 * torch.clamp_min(density[None, :], 1e-6))
        * w_spiky
        * (H - r) ** 2,
        0.0,
    )
    f_press = torch.sum(pterm[..., None] * diff / r[..., None], dim=1)

    # viscosity force: laplacian kernel 45/(pi h^6) (h - r)
    vterm = torch.where(
        within,
        VISCOSITY
        * PMASS
        / torch.clamp_min(density[None, :], 1e-6)
        * w_spiky
        * (H - r),
        0.0,
    )
    f_visc = torch.sum(
        vterm[..., None] * (vel[None, :, :] - vel[:, None, :]), dim=1
    )

    g = torch.tensor(G, dtype=torch.float32, device=dev)
    accel = (f_press + f_visc) / torch.clamp_min(density[:, None], 1e-6) + g
    vel_new = vel + DT * accel
    pos_new = pos + DT * vel_new

    # box walls: reflect with damping
    damp = -0.5
    low, high = 0.0, BOX
    vel_new = torch.where((pos_new < low) | (pos_new > high), vel_new * damp, vel_new)
    pos_new = torch.clamp(pos_new, low, high)
    return {"pos": pos_new, "vel": vel_new, "density": density}


def flops(n: int) -> float:
    return 60.0 * n * n  # all-pairs kernel evaluations dominate
