"""Energy model and optimizer (paper §2.3, Eq. 8) — node-level entry point.

    E(f, p, s, N) = P(f, p, s) × SVR(f, p, N)

The paper-faithful node API. The SVR surface and the power grid are
evaluated on the performance model's device; the masked grid argmin is the
engine's host ``solve_grid`` (one step-time floor, one ``Constraints``
class, configurable ``on_infeasible``, selectable objective).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import svr as svr_mod
from repro_torch.core.engine import (  # noqa: F401  (Constraints re-exported)
    TIME_FLOOR,
    Constraints,
    solve_grid,
)
from repro_torch.core.power import PowerModel
from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class Configuration:
    """One operating point, plus the model's estimates for it."""

    frequency_ghz: float
    cores: int
    sockets: int
    predicted_time_s: float
    predicted_power_w: float
    predicted_energy_j: float


def sockets_for_cores(cores: np.ndarray, cores_per_socket: int) -> np.ndarray:
    """Active sockets implied by a core count (paper's node: 16 cores/socket)."""
    return np.ceil(np.asarray(cores) / cores_per_socket).astype(np.int32)


def energy_grid(
    power_model: PowerModel,
    perf_model: svr_mod.SVRParams,
    *,
    frequencies: Sequence[float],
    cores: Sequence[int],
    input_size: float,
    cores_per_socket: int = 16,
):
    """Evaluate E = P × T on the full (f, p) grid. Returns host numpy
    (F, P, T, W, E)."""
    F, P = np.meshgrid(np.asarray(frequencies), np.asarray(cores), indexing="ij")
    S = sockets_for_cores(P, cores_per_socket)
    N = np.full_like(F, float(input_size))
    feats = np.stack([F.ravel(), P.ravel(), N.ravel()], axis=1)
    T = to_host(svr_mod.predict(perf_model, feats)).reshape(F.shape)
    T = np.maximum(T, TIME_FLOOR)  # SVR extrapolation may dip non-physical
    dev = getattr(perf_model, "device", torch.device("cpu"))
    W = to_host(
        power_model(
            torch.from_numpy(F).to(dev),
            torch.from_numpy(P).to(dev),
            torch.from_numpy(S).to(dev),
        )
    )
    E = W * T
    return F, P, T, W, E


def minimize_energy(
    power_model: PowerModel,
    perf_model: svr_mod.SVRParams,
    *,
    frequencies: Sequence[float],
    cores: Sequence[int],
    input_size: float,
    cores_per_socket: int = 16,
    constraints: Optional[Constraints] = None,
    objective: str = "energy",
    on_infeasible: str = "raise",
) -> Configuration:
    """Paper Eq. (8): argmin_{f,p} P(f,p,s(p)) × SVR(f,p,N)·T^k."""
    F, P, T, W, E = energy_grid(
        power_model,
        perf_model,
        frequencies=frequencies,
        cores=cores,
        input_size=input_size,
        cores_per_socket=cores_per_socket,
    )
    idx = solve_grid(
        F,
        P,
        T,
        W,
        objective=objective,
        constraints=constraints,
        on_infeasible=on_infeasible,
    )
    S = sockets_for_cores(np.array(P[idx]), cores_per_socket)
    return Configuration(
        frequency_ghz=float(F[idx]),
        cores=int(P[idx]),
        sockets=int(S),
        predicted_time_s=float(T[idx]),
        predicted_power_w=float(W[idx]),
        predicted_energy_j=float(E[idx]),
    )
