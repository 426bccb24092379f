"""Plain PyTorch versions of the port's Hopper kernels.

They are the CPU compute path (``ops.py`` sends CPU tensors here), the
ground truth the kernels are held against on the card, and the parity
target of the CPU tests against the JAX package. Each one computes the
same expression, in the same order, as its kernel under ``csrc/``: sums
over the feature axis are taken left to right one elementwise op at a time
(so no matmul or reduction reorders them), and ``T^k`` goes through
``tpow``, never ``torch.pow``.
"""

from __future__ import annotations

import torch

# rows of the (rows, G, G) pairwise test the Pareto plain version holds at
# once: keeps its temporaries near 250 MB at G = 352
_PARETO_ROWS_PER_CHUNK = 2048


def tpow(t: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """t ** k for the engine's exponents: 1, t and t*t for k = 0, 1, 2.

    ``torch.pow(t, 2.0)`` is not always ``t*t`` (it differs in the last bit
    of about 1.8% of float32 values), and a last-bit change in an ED²P
    metric can flip a near-tie argmin. Other exponents fall back to
    ``torch.pow``; the engine never asks for them.
    """
    k = k.to(t.dtype)
    out = torch.where(k == 2.0, t * t, torch.pow(t, k))
    out = torch.where(k == 1.0, t, out)
    return torch.where(k == 0.0, torch.ones_like(t), out)


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], left to right."""
    s = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        s = s + a[..., c] * b[..., c]
    return s


def rbf_gram_ref(x: torch.Tensor, y: torch.Tensor, gamma: float) -> torch.Tensor:
    """K[..., i, j] = exp(-gamma ||x_i - y_j||^2); x (..., n, d), y (..., m, d)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = _rowdot(x, x)[..., :, None]
    yy = _rowdot(y, y)[..., None, :]
    xy = _rowdot(x[..., :, None, :], y[..., None, :, :])
    d2 = torch.clamp_min(xx + yy - 2.0 * xy, 0.0)
    return torch.exp(-gamma * d2)


def plan_argmin_ref(
    t: torch.Tensor,  # (B, G) step times, G = nf * nc flattened C-order
    w: torch.Tensor,  # (1, G) shared power grid
    k: torch.Tensor,  # (B,)   per-workload objective exponent
    mask: torch.Tensor,  # (B, G) bool feasibility
    *,
    time_floor: float,
) -> torch.Tensor:
    """First flat index of the masked objective minimum, per row (int32).

    metric = (w·t)·t^k with t floored, masked points at +inf. Ties go to
    the first flat index; an all-masked row returns 0. A NaN step time
    stays NaN through the floor, and a feasible NaN metric comes first at
    its first index (``torch.argmin``'s order, as ``np.argmin`` in the
    engine's exact path).
    """
    t = torch.clamp_min(t.to(torch.float32), time_floor)
    e = w.to(torch.float32) * t
    metric = e * tpow(t, k.to(torch.float32)[:, None])
    masked = torch.where(mask, metric, torch.full_like(metric, float("inf")))
    return torch.argmin(masked, dim=1).to(torch.int32)


def pareto_mask_ref(
    t: torch.Tensor,  # (B, G) step times
    e: torch.Tensor,  # (B, G) energies
    mask: torch.Tensor,  # (B, G) bool feasibility
) -> torch.Tensor:
    """Pareto-frontier membership per row, (B, G) bool.

    A point survives iff it is feasible, finite in both axes, and no other
    feasible point q beats it: (tq < tp and eq <= ep), or (tq == tp and
    eq < ep), or an exact (t, e) tie with q at the lower flat index.
    """
    feas = mask & torch.isfinite(t) & torch.isfinite(e)
    g = t.shape[1]
    idx = torch.arange(g, device=t.device)
    lower = idx[:, None] < idx[None, :]  # (q, p): q before p
    out = []
    for r0 in range(0, t.shape[0], _PARETO_ROWS_PER_CHUNK):
        sl = slice(r0, r0 + _PARETO_ROWS_PER_CHUNK)
        tq, tp = t[sl, :, None], t[sl, None, :]  # q on axis 1, p on axis 2
        eq, ep = e[sl, :, None], e[sl, None, :]
        same_t = tq == tp
        beats = feas[sl, :, None] & (
            ((tq < tp) & (eq <= ep))
            | (same_t & (eq < ep))
            | (same_t & (eq == ep) & lower[None])
        )
        out.append(feas[sl] & ~beats.any(dim=1))
    if not out:
        return torch.zeros_like(feas)
    return torch.cat(out)
