"""Random-Fourier-feature characterization: the linear-in-n fit path.

The exact ε-SVR path (``svr.fit_many``) pays an n×n Gram build plus an
O(n³) active-set dual solve per training set — fine for the engine's
per-family sweeps (a few dozen samples), hopeless for drift refits that
want to digest 10× telemetry windows at fleet scale. This module
approximates the same RBF kernel with Rahimi–Recht random Fourier
features,

    z(x) = sqrt(2/D) · cos(x @ Wp + b),    Wp ~ N(0, 2γ),  b ~ U[0, 2π),

so that E[z(x)·z(y)] = exp(-γ‖x−y‖²) — exactly the ``kernels/rbf_gram``
kernel on the (standardized) feature axes — and fits a ridge regression
in the D-dimensional feature space. The normal-equations solve is
O(n·D²) (primal) or O(n²·D) (dual, taken automatically when n < D):
linear in sample count either way, with an optional matrix-free
conjugate-gradient solver for very large D. Sampling is seeded and
deterministic: the same ``seed`` always draws the same spectral
projection, so refits are reproducible and batched models share one
feature map.

Selection: callers never construct this directly — ``svr.fit_many``
routes sets here for ``method="rff"``, or automatically above
``svr.RFF_THRESHOLD`` samples for ``method="auto"`` (the
``PlanningEngine`` / drift-refit default). The parity gates live in
``tests/test_rff.py``: predictions track the exact fit, and — the gate
that matters — ``plan_many`` picks identical (f, cores) configs on the
shipped families.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Defaults shared by svr.fit_many's routing. D = 512 features reproduces
# the exact planner configs on every shipped family (tests/test_rff.py);
# the ridge is relative to the per-set sample count.
RFF_FEATURES = 512
RFF_SEED = 0
RFF_RIDGE = 1e-7


@dataclasses.dataclass(eq=False)
class RFFParams:
    """Fitted random-Fourier ridge surface (duck-types ``svr.SVRParams``
    for the predict paths: same standardization + log-target fields)."""

    w_proj: np.ndarray  # (d, D) spectral samples ~ N(0, 2*gamma)
    phase: np.ndarray  # (D,) phases ~ U[0, 2*pi)
    beta: np.ndarray  # (D,) ridge weights in feature space
    bias: float
    gamma: float
    x_mean: np.ndarray
    x_std: np.ndarray
    y_mean: float
    y_std: float
    log_target: bool = False
    seed: int = RFF_SEED


def sample_projection(
    d: int, n_features: int, gamma: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The seeded spectral sample for exp(-γ‖x−y‖²): deterministic in
    (d, n_features, gamma, seed)."""
    rng = np.random.default_rng(seed)
    w_proj = rng.normal(0.0, math.sqrt(2.0 * gamma), size=(d, n_features))
    phase = rng.uniform(0.0, 2.0 * math.pi, size=n_features)
    return w_proj, phase


def featurize(x: np.ndarray, w_proj: np.ndarray, phase: np.ndarray) -> np.ndarray:
    """z(x) = sqrt(2/D) cos(x @ Wp + b);  x (n, d) -> (n, D) float64."""
    x = np.asarray(x, np.float64)
    return math.sqrt(2.0 / w_proj.shape[1]) * np.cos(x @ w_proj + phase)


def cg_solve(
    matvec, rhs: np.ndarray, *, tol: float = 1e-10, max_iters: int = 500
) -> np.ndarray:
    """Plain conjugate gradients on an SPD operator (matrix-free option
    for D too large to factor; deterministic, zero initial guess)."""
    x = np.zeros_like(rhs)
    r = rhs - matvec(x)
    p = r.copy()
    rs = float(r @ r)
    for _ in range(max_iters):
        if rs <= tol * tol * float(rhs @ rhs) + 1e-300:
            break
        ap = matvec(p)
        alpha = rs / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rs_new = float(r @ r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def _solve_ridge(z: np.ndarray, y: np.ndarray, lam: float, solver: str) -> np.ndarray:
    """argmin_w ‖z w − y‖² + λ‖w‖², by whichever normal-equations side is
    smaller: primal (D×D, linear in n) or dual (n×n via the representer
    identity w = zᵀ(z zᵀ + λI)⁻¹ y, for thin sets n < D)."""
    n, dfeat = z.shape
    if solver == "cg":
        rhs = z.T @ y
        return cg_solve(lambda v: z.T @ (z @ v) + lam * v, rhs)
    if n < dfeat:
        a = z @ z.T
        a[np.diag_indices_from(a)] += lam
        return z.T @ np.linalg.solve(a, y)
    a = z.T @ z
    a[np.diag_indices_from(a)] += lam
    return np.linalg.solve(a, z.T @ y)


def fit_many_rff(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    gamma: float = 0.5,
    log_target: bool = False,
    standardize: bool = False,
    n_features: Optional[int] = None,
    seed: Optional[int] = None,
    ridge: Optional[float] = None,
    solver: str = "direct",
) -> List[RFFParams]:
    """Fit one RFF ridge surface per (x, y) pair — linear in sample count.

    Preprocessing mirrors ``svr.fit_many`` (same log floor, same
    standardization guards) so ``predict`` inverts identically; the
    spectral projection is shared across the batch (one seed), so models
    fitted together are directly comparable.
    """
    dfeat = RFF_FEATURES if n_features is None else int(n_features)
    seed = RFF_SEED if seed is None else int(seed)
    ridge = RFF_RIDGE if ridge is None else float(ridge)
    models: List[RFFParams] = []
    w_proj = phase = None
    for x_raw, y_raw in pairs:
        x = np.asarray(x_raw, np.float32)
        y = np.asarray(y_raw, np.float32)
        if log_target:
            y = np.log(np.maximum(y, 1e-12))
        if standardize:
            x_mean = np.mean(x, axis=0)
            x_std = np.std(x, axis=0) + np.float32(1e-8)
            y_mean = np.float32(np.mean(y))
            y_std = np.float32(np.std(y) + 1e-8)
        else:
            x_mean = np.zeros(x.shape[1], np.float32)
            x_std = np.ones(x.shape[1], np.float32)
            y_mean = np.float32(0.0)
            y_std = np.float32(1.0)
        xs = ((x - x_mean) / x_std).astype(np.float64)
        ys = ((y - y_mean) / y_std).astype(np.float64)
        if w_proj is None:
            w_proj, phase = sample_projection(x.shape[1], dfeat, gamma, seed)
        z = featurize(xs, w_proj, phase)
        n = max(z.shape[0], 1)
        # bias via an explicit constant feature; λ scales with n so the
        # effective regularization per sample is size-independent
        zb = np.concatenate([z, np.ones((z.shape[0], 1))], axis=1)
        wb = _solve_ridge(zb, ys, ridge * n, solver)
        models.append(
            RFFParams(
                w_proj=w_proj,
                phase=phase,
                beta=wb[:-1],
                bias=float(wb[-1]),
                gamma=gamma,
                x_mean=x_mean,
                x_std=x_std,
                y_mean=float(y_mean),
                y_std=float(y_std),
                log_target=log_target,
                seed=seed,
            )
        )
    return models


def predict(params: RFFParams, x: np.ndarray) -> np.ndarray:
    """Raw-unit predictions for raw-unit features x (m, d) — the RFF twin
    of ``svr.predict`` (``svr.predict``/``predict_each`` dispatch here)."""
    xs = (np.asarray(x, np.float64) - params.x_mean) / params.x_std
    z = featurize(xs, params.w_proj, params.phase)
    ys = z @ params.beta + params.bias
    out = ys * params.y_std + params.y_mean
    return np.exp(out) if params.log_target else out


def predict_each(
    models: Sequence[RFFParams], xs: Sequence[np.ndarray]
) -> List[np.ndarray]:
    """Model i on its own query set — host-side matvecs, no device round
    trip (the feature map is the whole model; there is no Gram build to
    batch)."""
    return [predict(m, q) for m, q in zip(models, xs)]
