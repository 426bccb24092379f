"""ε-Support-Vector-Regression with RBF kernel (paper §2.2), on PyTorch.

The paper characterizes application performance as T = SVR(f, p, N) with an
RBF kernel, C = 10·10^3, γ = 0.5, trained on execution-time samples over the
(frequency, cores, input-size) grid.

We solve the standard ε-SVR dual in the β = α - α* parametrization:

    max_β  -½ βᵀ K β + yᵀ β - ε ‖β‖₁     s.t.  Σβ = 0,  |β_i| ≤ C

with a float64 host active-set method (equality-constrained KKT solves with
box-bounded duals pinned by identity rows, KKT-driven bind/release),
optionally polished by a monotone projected proximal-gradient (ISTA) pass
on the device. The Gram matrix — the compute hotspot — is built on the
device by ``kernels.ops.rbf_gram`` (the Hopper kernel for a CUDA device)
and copied to the host in float64 for the solve.

``fit_many`` stacks many training sets (ragged ones padded with masked
rows), builds their Gram tensor in ONE ``rbf_gram`` call and solves the
KKT systems batched over the leading dim; the ISTA polish (``iters > 0``)
runs batched over the same float32 Gram. ``fit`` is its B = 1 wrapper.
Fitted models hold their tensors on the device they were fitted on, and
``predict`` / ``predict_many`` / ``predict_each`` evaluate there, many
models in one Gram call. ``kfold_cv`` and ``grid_search`` are the paper's
§3.4 validation (Table 1's MAE and PAE), with the reference's folds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import rff as rff_mod
from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.kernels import ops

# ``method="auto"`` switch point for fit_many: sets with at least this many
# samples take the random-Fourier-feature path (linear in n) instead of the
# exact O(n^3) dual solve.
RFF_THRESHOLD = 1024


@dataclasses.dataclass
class SVRParams:
    """Fitted model state: tensors on one device + static hyper-params."""

    x_train: torch.Tensor  # (n, d) standardized
    beta: torch.Tensor  # (n,) dual coefficients
    bias: float
    gamma: float
    x_mean: torch.Tensor  # (d,)
    x_std: torch.Tensor  # (d,)
    y_mean: float
    y_std: float
    log_target: bool = False

    @property
    def device(self) -> torch.device:
        return self.beta.device


def _matvec(K: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, n, n) @ (B, n) -> (B, n)."""
    return torch.bmm(K, v[..., None])[..., 0]


def _project_sum_zero_box(
    beta: torch.Tensor, C: torch.Tensor, mask: torch.Tensor, iters: int = 50
) -> torch.Tensor:
    """Project each row of beta (B, n) onto {Σβ = 0, |β_i| ≤ C_b}: bisection
    on λ in clip(β-λ, -C, C). ``mask`` (B, n) marks the real rows of a
    padded problem: masked-out entries are pinned to 0 and excluded from
    the Σβ = 0 constraint."""
    m = mask.to(beta.dtype)
    Cb = C[:, None]
    inf = torch.full_like(beta, float("inf"))
    lo = torch.where(mask, beta, inf).amin(1) - C
    hi = torch.where(mask, beta, -inf).amax(1) + C
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = (m * torch.clamp(beta - mid[:, None], -Cb, Cb)).sum(1) > 0
        lo = torch.where(above, mid, lo)
        hi = torch.where(above, hi, mid)
    lam = 0.5 * (lo + hi)
    return m * torch.clamp(beta - lam[:, None], -Cb, Cb)


def _ista_refine_batch(
    K: torch.Tensor,
    y: torch.Tensor,
    beta0: torch.Tensor,
    C: torch.Tensor,
    eps: torch.Tensor,
    mask: torch.Tensor,
    iters: int = 200,
) -> torch.Tensor:
    """Monotone proximal-gradient refinement of B warm starts towards the
    true ε-SVR optimum, batched over K (B, n, n): step 1/λ_max(K) (50 power
    steps), soft-threshold for ε‖β‖₁, exact projection onto {Σβ=0, |β|≤C,
    β_pad=0}. Keeps each item's best-objective iterate (ISTA on this
    near-singular K is descent-stable where FISTA momentum is not)."""
    m = mask.to(K.dtype)
    v = m / torch.sqrt(torch.clamp_min(m.sum(1, keepdim=True), 1.0))
    for _ in range(50):
        w = _matvec(K, v)
        v = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-12)
    step = 0.9 / torch.clamp_min((v * _matvec(K, v)).sum(1), 1e-6)

    def obj(b):
        return 0.5 * (b * _matvec(K, b)).sum(1) - (y * b).sum(1) + eps * b.abs().sum(1)

    beta = beta0 * m
    best, best_obj = beta, obj(beta)
    for _ in range(iters):
        z = beta - step[:, None] * (_matvec(K, beta) - y)
        z = torch.sign(z) * torch.clamp_min(z.abs() - (step * eps)[:, None], 0.0)
        beta = _project_sum_zero_box(z, C, mask)
        o = obj(beta)
        take = o < best_obj
        best = torch.where(take[:, None], beta, best)
        best_obj = torch.where(take, o, best_obj)
    return best


def _recover_bias_batch(
    K: torch.Tensor, y: torch.Tensor, beta: torch.Tensor, C: torch.Tensor,
    eps: torch.Tensor, mask: torch.Tensor,
) -> torch.Tensor:
    """KKT, per item: the mean over free SVs (0 < |β| < C) of
    y_i - (Kβ)_i - sign(β_i)·ε; without free SVs the median of y - Kβ over
    the real rows (the mean of the two middle values for an even count, as
    ``jnp.nanmedian``)."""
    f = _matvec(K, beta)
    tol = (1e-6 * C)[:, None]
    a = beta.abs()
    free = mask & (a > tol) & (a < C[:, None] - tol)
    cand = y - f - torch.sign(beta) * eps[:, None]
    n_free = free.sum(1)
    b_free = torch.where(free, cand, 0.0).sum(1) / torch.clamp_min(n_free, 1)
    b_fallback = torch.nanquantile(torch.where(mask, y - f, float("nan")), 0.5, dim=1)
    return torch.where(n_free > 0, b_free, b_fallback)


def _active_set_solve_batch(
    K: np.ndarray,
    y: np.ndarray,
    C: np.ndarray,
    eps: np.ndarray,
    mask: np.ndarray,
    *,
    lam: float = 1e-3,
    max_rounds: int = 30,
):
    """Batched active-set solve of B ε-SVR duals (float64, exact up to the
    tiny ridge λ used for conditioning of the near-singular RBF Gram).

    K: (B, n, n) Gram stack (padded rows/cols zeroed), y: (B, n), C/eps:
    (B,) per-item box/tube in standardized units, mask: (B, n) real rows.

    Per round: one batched solve of the pinned (n+1)×(n+1) KKT systems;
    clip |β_free| > C and bind the worst quartile of violators; after a
    clean solve, release bounded points whose KKT multiplier sign flipped.
    Items converge independently and drop out; a period-2 sign cycle is
    detected and stopped. Returns (beta (B, n), bias (B,)).
    """
    B, n = y.shape
    K64 = np.asarray(K, np.float64)
    y64 = np.asarray(y, np.float64)
    bound = np.zeros((B, n), bool)
    beta = np.zeros((B, n))
    sign = np.zeros((B, n))
    sign_prev = np.full((B, n), 2.0)  # sentinel: matches no real sign pattern

    best_beta = np.zeros((B, n))
    best_bias = np.array(
        [float(np.median(y64[i, mask[i]])) if mask[i].any() else 0.0 for i in range(B)]
    )
    best_obj = np.zeros(B)  # dual objective of β = 0
    done = np.zeros(B, bool)

    for _ in range(max_rounds):
        act = np.where(~done)[0]
        if act.size == 0:
            break
        Ka, ya = K64[act], y64[act]
        Ca, ea = C[act][:, None], eps[act][:, None]
        free = mask[act] & ~bound[act]
        nf = free.sum(1)

        A = np.zeros((act.size, n + 1, n + 1))
        rhs = np.zeros((act.size, n + 1))
        A[:, :n, :n] = Ka
        A[:, np.arange(n), np.arange(n)] += lam
        A[:, :n, n] = 1.0
        pi, pj = np.nonzero(~free)  # pin bound/padded duals: identity rows
        A[pi, pj, :] = 0.0
        A[pi, pj, pj] = 1.0
        A[:, n, :n] = mask[act].astype(float)  # Σβ = 0 over real rows
        degenerate = nf == 0  # all real duals bound: b has no equation left;
        A[degenerate, n, :] = 0.0  # replace the Σβ row outright with b = 0
        A[degenerate, n, n] = 1.0
        rhs[:, :n] = ya - ea * sign[act]
        rhs[pi, pj] = np.where(bound[act][pi, pj], beta[act][pi, pj], 0.0)
        sol = np.linalg.solve(A, rhs[..., None])[..., 0]
        beta_sol, b_sol = sol[:, :n], sol[:, n]

        beta_new = np.where(free, np.clip(beta_sol, -Ca, Ca), beta[act])
        sign_new = np.where(free, np.sign(beta_sol), sign[act])
        viol = free & (np.abs(beta_sol) > Ca)
        clean = ~viol.any(1)

        obj = (
            0.5 * np.einsum("bi,bij,bj->b", beta_new, Ka, beta_new)
            - np.einsum("bi,bi->b", ya, beta_new)
            + eps[act] * np.abs(beta_new).sum(1)
        )
        take = clean & (obj < best_obj[act])
        best_beta[act[take]] = beta_new[take]
        best_bias[act[take]] = b_sol[take]
        best_obj[act[take]] = obj[take]

        grad = (
            np.einsum("bij,bj->bi", Ka, beta_new)
            + lam * beta_new
            - ya
            + b_sol[:, None]
        )
        moved = np.zeros(act.size, bool)
        for j in range(act.size):
            i = act[j]
            if viol[j].any():
                over = np.where(viol[j], np.abs(beta_sol[j]) - C[i], -np.inf)
                k = max(1, int(viol[j].sum() // 4))
                bound[i, np.argsort(-over)[:k]] = True
                moved[j] = True
            elif bound[i].any():
                release = bound[i] & (
                    ((beta_new[j] >= C[i] - 1e-12) & (grad[j] + eps[i] > 1e-6))
                    | ((beta_new[j] <= -C[i] + 1e-12) & (grad[j] - eps[i] < -1e-6))
                )
                if release.any():
                    bound[i, release] = False
                    moved[j] = True

        stable = (sign_new == sign[act]).all(1)
        cycled = (sign_new == sign_prev[act]).all(1)
        beta[act] = beta_new
        sign_prev[act] = sign[act]
        sign[act] = sign_new
        done[act] |= (~moved) & (stable | cycled)

    return best_beta, best_bias


def _solve_dual_ladder(
    K: np.ndarray,
    y: np.ndarray,
    C: np.ndarray,
    eps: np.ndarray,
    mask: np.ndarray,
    ridge: float,
):
    """Per-item ridge escalation over the batched active-set solve: items
    whose training fit reaches relative residual < 0.10 drop out of the
    remaining rungs, so well-conditioned batches pay one rung."""
    B, n = y.shape
    best_rel = np.full(B, np.inf)
    out_beta = np.zeros((B, n))
    out_bias = np.zeros(B)
    todo = np.arange(B)
    for lam in (ridge, 3 * ridge, 10 * ridge, 100 * ridge):
        if todo.size == 0:
            break
        beta, bias = _active_set_solve_batch(
            K[todo], y[todo], C[todo], eps[todo], mask[todo], lam=lam
        )
        resid = np.abs(
            np.einsum("bij,bj->bi", K[todo], beta) + bias[:, None] - y[todo]
        )
        rel = (
            np.where(mask[todo], resid / np.maximum(np.abs(y[todo]), 1e-9), 0.0).sum(1)
            / np.maximum(mask[todo].sum(1), 1)
        )
        better = rel < best_rel[todo]
        upd = todo[better]
        out_beta[upd] = beta[better]
        out_bias[upd] = bias[better]
        best_rel[upd] = rel[better]
        todo = todo[rel >= 0.10]
    return out_beta, out_bias


def _as_xy(item):
    """Accept a (x, y) pair or a Characterization-like (.features/.times)."""
    feats = getattr(item, "features", None)
    if feats is not None:
        return np.asarray(feats), np.asarray(item.times)
    x, y = item
    return np.asarray(x), np.asarray(y)


def _fit_meta(x_mean, x_std, y_mean, y_std, eps: float, C: float):
    """One item's standardization record. ε and C are specified in
    raw-target units; the rescale to standardized units lives ONLY here."""
    return (
        x_mean,
        x_std,
        float(y_mean),
        float(y_std),
        eps / float(y_std),
        C / float(y_std),
    )


def fit_many(
    sets: Sequence,
    *,
    C: float = 10e3,
    gamma: float = 0.5,
    eps: float = 0.01,
    iters: int = 0,
    impl: Optional[str] = None,
    log_target: bool = False,
    standardize: bool = False,
    ridge: float = 1e-3,
    method: str = "exact",
    rff_features: Optional[int] = None,
    rff_seed: Optional[int] = None,
    rff_ridge: Optional[float] = None,
    rff_threshold: Optional[int] = None,
    device: DeviceLike = None,
) -> list:
    """Fit B ε-SVR models in one batched pass — one model per training set.

    Args:
        sets: B training sets, each (x (n, d), y (n,)) or an object with
            ``.features`` / ``.times``: raw features (frequency GHz, cores,
            input size) and raw targets in seconds.
        C / eps: the ε-SVR box bound and tube, in raw-target units.
        gamma: RBF width on the (possibly standardized) feature axes.
        iters: ISTA polish iterations (0 = active-set solution only), on
            the fit's device over the float32 Gram.
        log_target / standardize: the beyond-paper mode for features
            spanning orders of magnitude (the engine path).
        ridge: base conditioning ridge for the KKT solves.
        method: ``"exact"``, ``"rff"`` or ``"auto"`` (RFF at or above
            ``rff_threshold`` samples), as in the reference.
        device: where the Gram matrix is built and the models live;
            ``None`` is the CUDA device (raises without one).

    Returns:
        ``List[SVRParams]`` (``rff.RFFParams`` for RFF-routed sets), aligned
        with ``sets``.
    """
    dev = resolve_device(device)
    pairs = [_as_xy(s) for s in sets]
    if not pairs:
        return []

    if method not in ("exact", "rff", "auto"):
        raise ValueError(f"unknown fit method: {method!r}")
    if method != "exact":
        thr = RFF_THRESHOLD if rff_threshold is None else int(rff_threshold)
        use_rff = [
            method == "rff" or int(np.shape(x)[0]) >= thr for x, _ in pairs
        ]
        if any(use_rff):
            rff_kw = dict(
                gamma=gamma,
                log_target=log_target,
                standardize=standardize,
                n_features=rff_features,
                seed=rff_seed,
                ridge=rff_ridge,
            )
            if all(use_rff):
                obs.counter("svr.fit_route_rff").inc(len(pairs))
                return rff_mod.fit_many_rff(pairs, **rff_kw)
            rff_idx = [i for i, u in enumerate(use_rff) if u]
            obs.counter("svr.fit_route_rff").inc(len(rff_idx))
            exact_idx = [i for i, u in enumerate(use_rff) if not u]
            merged: list = [None] * len(pairs)
            for i, m in zip(
                rff_idx, rff_mod.fit_many_rff([pairs[i] for i in rff_idx], **rff_kw)
            ):
                merged[i] = m
            exact_models = fit_many(
                [pairs[i] for i in exact_idx],
                C=C,
                gamma=gamma,
                eps=eps,
                iters=iters,
                impl=impl,
                log_target=log_target,
                standardize=standardize,
                ridge=ridge,
                device=dev,
            )
            for i, m in zip(exact_idx, exact_models):
                merged[i] = m
            return merged

    obs.counter("svr.fit_route_exact").inc(len(pairs))

    # preprocessing stays in numpy, exactly as the reference does it
    B = len(pairs)
    ns = [int(np.shape(p[0])[0]) for p in pairs]
    n_max = max(ns)
    d = int(np.shape(pairs[0][0])[1])
    if len(set(ns)) == 1:
        X = np.stack([np.asarray(x, np.float32) for x, _ in pairs])
        Y = np.stack([np.asarray(y, np.float32) for _, y in pairs])
        if log_target:
            Y = np.log(np.maximum(Y, 1e-12))
        if standardize:
            x_mean = np.mean(X, axis=1)
            x_std = np.std(X, axis=1) + np.float32(1e-8)
            y_mean = np.mean(Y, axis=1).astype(np.float32)
            y_std = (np.std(Y, axis=1) + 1e-8).astype(np.float32)
        else:
            x_mean = np.zeros((B, d), np.float32)
            x_std = np.ones((B, d), np.float32)
            y_mean = np.zeros(B, np.float32)
            y_std = np.ones(B, np.float32)
        Xp = ((X - x_mean[:, None, :]) / x_std[:, None, :]).astype(np.float32)
        Yp = ((Y - y_mean[:, None]) / y_std[:, None]).astype(np.float32)
        mask = np.ones((B, n_max), bool)
        xs_std = list(Xp)
        metas = [
            _fit_meta(x_mean[i], x_std[i], y_mean[i], y_std[i], eps, C)
            for i in range(B)
        ]
    else:
        xs_std, ys_std, metas = [], [], []
        for x_raw, y_raw in pairs:
            x = np.asarray(x_raw, np.float32)
            y = np.asarray(y_raw, np.float32)
            if log_target:
                y = np.log(np.maximum(y, 1e-12))
            if standardize:
                x_mean = np.mean(x[None], axis=1)[0]
                x_std = np.std(x[None], axis=1)[0] + np.float32(1e-8)
                y_mean = np.float32(np.mean(y[None], axis=1)[0])
                y_std = np.float32(np.std(y[None], axis=1)[0] + 1e-8)
            else:
                x_mean = np.zeros(x.shape[1], np.float32)
                x_std = np.ones(x.shape[1], np.float32)
                y_mean = np.float32(0.0)
                y_std = np.float32(1.0)
            xs_std.append(((x - x_mean) / x_std).astype(np.float32))
            ys_std.append(((y - y_mean) / y_std).astype(np.float32))
            metas.append(_fit_meta(x_mean, x_std, y_mean, y_std, eps, C))
        Xp = np.zeros((B, n_max, d), np.float32)
        Yp = np.zeros((B, n_max), np.float32)
        mask = np.zeros((B, n_max), bool)
        for i, (xs, ys) in enumerate(zip(xs_std, ys_std)):
            Xp[i, : ns[i]] = xs
            Yp[i, : ns[i]] = ys
            mask[i, : ns[i]] = True

    # the compute hotspot: every training set's Gram block in ONE call, on
    # the device; the KKT ladder runs on the host in float64
    with obs.span("svr.fit_exact", cat="svr", batch=B, n_max=n_max):
        Xd = torch.from_numpy(Xp).to(dev)
        K = ops.rbf_gram(Xd, Xd, gamma, impl=impl)
        K64 = to_host(K).astype(np.float64)
        ragged = not mask.all()
        if ragged:  # zero the padded Gram rows/cols (pads are not real)
            pairs_mask = mask[:, :, None] & mask[:, None, :]
            K64 *= pairs_mask
        C_s = np.asarray([m[5] for m in metas], np.float64)
        eps_s = np.asarray([m[4] for m in metas], np.float64)
        beta, bias = _solve_dual_ladder(
            K64, np.asarray(Yp, np.float64), C_s, eps_s, mask, ridge
        )

    if iters > 0:
        if ragged:
            K = K * torch.from_numpy(pairs_mask).to(dev)
        Yd = torch.from_numpy(Yp).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        C_d = torch.from_numpy(C_s.astype(np.float32)).to(dev)
        eps_d = torch.from_numpy(eps_s.astype(np.float32)).to(dev)
        beta_r = _ista_refine_batch(
            K, Yd, torch.from_numpy(beta.astype(np.float32)).to(dev), C_d, eps_d, mask_d,
            iters=iters,
        )
        bias_r = to_host(_recover_bias_batch(K, Yd, beta_r, C_d, eps_d, mask_d)).astype(
            np.float64)
        beta = to_host(beta_r).astype(np.float64)
        # only accept the polished bias where it stays sane (the polish can't
        # worsen the dual objective, but bias recovery on a degenerate free
        # set can); otherwise keep the active-set KKT bias
        sane = np.isfinite(bias_r) & (np.abs(bias_r - bias) <= 1.0)
        bias = np.where(sane, bias_r, bias)

    models = []
    for i in range(B):
        x_mean, x_std, y_mean, y_std, _, _ = metas[i]
        models.append(
            SVRParams(
                x_train=torch.from_numpy(np.ascontiguousarray(xs_std[i])).to(dev),
                beta=torch.from_numpy(beta[i, : ns[i]].astype(np.float32)).to(dev),
                bias=float(bias[i]),
                gamma=gamma,
                x_mean=torch.from_numpy(np.asarray(x_mean, np.float32)).to(dev),
                x_std=torch.from_numpy(np.asarray(x_std, np.float32)).to(dev),
                y_mean=y_mean,
                y_std=y_std,
                log_target=log_target,
            )
        )
    return models


def fit(
    x: np.ndarray,
    y: np.ndarray,
    *,
    C: float = 10e3,
    gamma: float = 0.5,
    eps: float = 0.01,
    iters: int = 0,
    impl: Optional[str] = None,
    log_target: bool = False,
    standardize: bool = False,
    ridge: float = 1e-3,
    device: DeviceLike = None,
) -> SVRParams:
    """Fit one ε-SVR step-time surface (paper §2.2): the B = 1 view of
    ``fit_many``. x (n, d) raw features, y (n,) seconds."""
    return fit_many(
        [(x, y)],
        C=C,
        gamma=gamma,
        eps=eps,
        iters=iters,
        impl=impl,
        log_target=log_target,
        standardize=standardize,
        ridge=ridge,
        device=device,
    )[0]


def _queries(x, device: torch.device) -> torch.Tensor:
    """Raw query features as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def predict(params: SVRParams, x, *, impl: Optional[str] = None):
    """Predict raw-unit targets for raw-unit features x: (m, d).

    A tensor on the model's device; an ``rff.RFFParams`` model predicts on
    the host and returns a numpy array."""
    if isinstance(params, rff_mod.RFFParams):
        return rff_mod.predict(params, to_host(x))
    xs = (_queries(x, params.device) - params.x_mean) / params.x_std
    K = ops.rbf_gram(xs, params.x_train, params.gamma, impl=impl)
    ys = K @ params.beta + params.bias
    out = ys * params.y_std + params.y_mean
    return torch.exp(out) if params.log_target else out


def predict_many(models: Sequence[SVRParams], x, *, impl: Optional[str] = None):
    """Many fitted models over one shared query grid, in one ``rbf_gram``
    call (the engine's hot path). Returns per-model predictions."""
    models = list(models)
    return predict_each(models, [x] * len(models), impl=impl)


def predict_each(models: Sequence[SVRParams], xs: Sequence, *,
                 impl: Optional[str] = None):
    """Model i evaluated on its OWN query set ``xs[i]``; homogeneous models
    and same-shape queries go through one ``rbf_gram`` call, anything else
    falls back to per-model ``predict``."""
    models = list(models)
    if not models:
        return []
    if any(isinstance(m, rff_mod.RFFParams) for m in models):
        if all(isinstance(m, rff_mod.RFFParams) for m in models):
            return rff_mod.predict_each(models, [to_host(q) for q in xs])
        return [predict(m, q, impl=impl) for m, q in zip(models, xs)]
    m0 = models[0]
    q0 = tuple(np.shape(xs[0]))
    homogeneous = all(
        m.x_train.shape == m0.x_train.shape
        and m.gamma == m0.gamma
        and m.log_target == m0.log_target
        and m.device == m0.device
        for m in models[1:]
    ) and all(tuple(np.shape(q)) == q0 for q in xs[1:])
    if not homogeneous:
        return [predict(m, q, impl=impl) for m, q in zip(models, xs)]
    dev = m0.device
    Xs = torch.stack(
        [(_queries(q, dev) - m.x_mean) / m.x_std for m, q in zip(models, xs)]
    )  # (B, m, d)
    Yt = torch.stack([m.x_train for m in models])  # (B, n, d)
    K = ops.rbf_gram(Xs, Yt, m0.gamma, impl=impl)  # (B, m, n) — one call
    out = _predict_from_gram(
        K,
        torch.stack([m.beta for m in models]),
        torch.tensor([m.bias for m in models], dtype=torch.float32, device=dev),
        torch.tensor([m.y_mean for m in models], dtype=torch.float32, device=dev),
        torch.tensor([m.y_std for m in models], dtype=torch.float32, device=dev),
        m0.log_target,
    )
    return list(out)


def _predict_from_gram(K, beta, bias, y_mean, y_std, log_target: bool):
    ys = torch.einsum("bmn,bn->bm", K, beta) + bias[:, None]
    out = ys * y_std[:, None] + y_mean[:, None]
    return torch.exp(out) if log_target else out


def pae_from_pred(pred, y) -> float:
    """Percentage absolute error from precomputed predictions."""
    y = np.asarray(y, np.float64)
    pred = to_host(pred).astype(np.float64)
    return float(np.mean(np.abs(pred - y) / np.maximum(y, 1e-9)))


def pae(params: SVRParams, x, y) -> float:
    """Percentage absolute error (paper Table 1 metric)."""
    return pae_from_pred(predict(params, x), y)


def mae(params: SVRParams, x, y) -> float:
    """Mean absolute error of ``predict`` against y (float32, on the model's
    device)."""
    pred = predict(params, x)
    if not isinstance(pred, torch.Tensor):  # an RFF model predicts on the host
        pred = torch.from_numpy(np.asarray(pred, np.float32))
    return float(torch.mean(torch.abs(pred - _queries(y, pred.device))))


def kfold_cv(
    x: np.ndarray,
    y: np.ndarray,
    *,
    k: int = 10,
    C: float = 10e3,
    gamma: float = 0.5,
    eps: float = 0.01,
    iters: int = 0,
    seed: int = 0,
    log_target: bool = False,
    standardize: bool = False,
    device: DeviceLike = None,
):
    """Paper §3.4: k-fold cross validation, returns mean (MAE, PAE).

    The folds are ``np.array_split`` of ``np.random.default_rng(seed)``'s
    permutation, as in the reference; each fold fits with ``fit`` on
    ``device`` (``None``: the CUDA device) and scores its held-out samples.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    n = x.shape[0]
    folds = np.array_split(np.random.default_rng(seed).permutation(n), k)
    maes, paes = [], []
    for i in range(k):
        test_idx = folds[i]
        train_idx = np.concatenate([folds[j] for j in range(k) if j != i])
        m = fit(
            x[train_idx],
            y[train_idx],
            C=C,
            gamma=gamma,
            eps=eps,
            iters=iters,
            log_target=log_target,
            standardize=standardize,
            device=dev,
        )
        maes.append(mae(m, x[test_idx], y[test_idx]))
        paes.append(pae(m, x[test_idx], y[test_idx]))
    return float(np.mean(maes)), float(np.mean(paes))


def grid_search(
    x,
    y,
    *,
    Cs=(1e2, 1e3, 10e3),
    gammas=(0.1, 0.5, 1.0),
    eps: float = 0.01,
    k: int = 5,
    iters: int = 0,
    device: DeviceLike = None,
):
    """Paper §3.4's hyper-parameter grid search: the (C, γ) of the lowest CV
    PAE, the first on a tie."""
    best = None
    for C in Cs:
        for g in gammas:
            _, p = kfold_cv(x, y, k=k, C=C, gamma=g, eps=eps, iters=iters, device=device)
            if best is None or p < best[0]:
                best = (p, C, g)
    return {"pae": best[0], "C": best[1], "gamma": best[2]}
