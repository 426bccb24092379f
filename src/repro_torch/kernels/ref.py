"""Plain PyTorch versions of the port's Hopper kernels.

They are the CPU compute path (``ops.py`` sends CPU tensors here), the
ground truth the kernels are held against on the card, and the parity
target of the CPU tests against the JAX package.

The planning kernels' versions compute the same expression, in the same
order, as their kernels under ``csrc/``: sums over the feature axis are
taken left to right one elementwise op at a time (so no matmul or
reduction reorders them), and ``T^k`` goes through ``tpow``, never
``torch.pow``. The attention and SSD versions mirror the reference's jnp
oracles (chunked online softmax, chunked SSD) in float32; their kernels
sum in another order, so they agree within a stated tolerance. The
flash-attention backward is plain torch only, as the reference's (its
kernels are forward-only). The int8 codec's versions and its kernels
compute the same roundings and agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

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


# ---------------------------------------------------------------------------
# Attention (plain versions of csrc/flash_attention.cu)
# ---------------------------------------------------------------------------


def _attn_mask(q_pos, k_pos, causal: bool, window: Optional[int],
               kv_len: Optional[int]) -> torch.Tensor:
    """True where attention is allowed, (bq, bk)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_len is not None:
        m &= k_pos[None, :] < kv_len
    return m


def flash_attention_ref(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hk, skv, d)
    v: torch.Tensor,  # (b, hk, skv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    block_q: int = 512,
    block_k: int = 512,
    return_lse: bool = False,
):
    """Chunked online-softmax attention with GQA (hk | h), in float32.

    The reference's ``flash_attention_ref``: q chunks (outer) by kv chunks
    (inner) with a running (max, sum, acc) carry, masked scores at -inf,
    a fully masked row gives 0. Queries sit at positions
    ``q_offset .. q_offset + sq``; keys at or past ``kv_len`` are masked.
    Output in q's dtype; ``return_lse`` also returns the log-sum-exp of
    every row (b, h, sq) f32, -inf for a fully masked row, which
    ``flash_attention_bwd_ref`` recomputes the probabilities from.
    """
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    if h % hk:
        raise ValueError(f"{h} query heads are not a multiple of {hk} kv heads")
    groups = h // hk
    if scale is None:
        scale = 1.0 / (d**0.5)
    bq = min(block_q, sq)
    bk = min(block_k, skv)
    pq = (-sq) % bq
    pk = (-skv) % bk
    qp = torch.nn.functional.pad(q, (0, 0, 0, pq)) if pq else q
    kp = torch.nn.functional.pad(k, (0, 0, 0, pk)) if pk else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk)) if pk else v
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bk
    eff_kv_len = skv if (pk or kv_len is not None) else None
    if kv_len is not None:
        eff_kv_len = kv_len
    dev = q.device
    qs = qp.reshape(b, hk, groups, nq, bq, d)
    ks = kp.reshape(b, hk, nk, bk, d)
    vs = vp.reshape(b, hk, nk, bk, d)
    outs, lses = [], []
    for iq in range(nq):
        q_blk = qs[:, :, :, iq].float()  # (b, hk, g, bq, d)
        q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((b, hk, groups, bq, d), dtype=torch.float32, device=dev)
        m = torch.full((b, hk, groups, bq), float("-inf"), device=dev)
        l = torch.zeros((b, hk, groups, bq), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k_blk = ks[:, :, ik].float()  # (b, hk, bk, d)
            v_blk = vs[:, :, ik].float()
            k_pos = ik * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk) * scale
            mask = _attn_mask(q_pos, k_pos, causal, window, eff_kv_len)
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, v_blk)
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        lses.append(torch.where(l > 0, m_safe + torch.log(torch.clamp_min(l, 1e-30)),
                                float("-inf")))
    out = torch.stack(outs, dim=3).reshape(b, hk, groups, nq * bq, d)
    out = out[..., :sq, :].reshape(b, h, sq, d)
    if return_lse:
        lse = torch.stack(lses, dim=3).reshape(b, hk, groups, nq * bq)
        return out, lse[..., :sq].reshape(b, h, sq)
    return out


def flash_attention_bwd_ref(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hk, skv, d)
    v: torch.Tensor,  # (b, hk, skv, d)
    out: torch.Tensor,  # (b, h, sq, d)
    lse: torch.Tensor,  # (b, h, sq) f32
    dout: torch.Tensor,  # (b, h, sq, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_len: Optional[int] = None,
    block_q: int = 512,
    block_k: int = 512,
):
    """Flash-attention backward with O(S) residual memory, the reference's
    ``flash_attention_bwd_ref`` (Dao et al., alg. 2): kv chunks (outer) by
    q chunks (inner), probabilities recomputed from (q, k, lse), dq / dk /
    dv accumulated chunk by chunk in float32, with the GQA group axis kept
    in the dk / dv sums until both loops end, as the reference sums it.
    Returns (dq, dk, dv) in the dtypes of q, k, v.
    """
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    groups = h // hk
    if scale is None:
        scale = 1.0 / (d**0.5)
    bq = min(block_q, sq)
    bk = min(block_k, skv)
    pq = (-sq) % bq
    pk = (-skv) % bk

    def pad4(x, p):
        return torch.nn.functional.pad(x, (0, 0, 0, p)) if p else x

    qp, op_, dop = pad4(q, pq), pad4(out, pq), pad4(dout, pq)
    kp, vp = pad4(k, pk), pad4(v, pk)
    lsep = torch.nn.functional.pad(lse, (0, pq), value=float("inf")) if pq else lse
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bk
    eff_kv_len = kv_len if kv_len is not None else (skv if pk else None)
    dev = q.device
    qg = qp.reshape(b, hk, groups, nq, bq, d)
    dog = dop.reshape(b, hk, groups, nq, bq, d)
    lseg = lsep.reshape(b, hk, groups, nq, bq)
    Dg = (dog.float() * op_.reshape(b, hk, groups, nq, bq, d).float()).sum(dim=-1)
    ks = kp.reshape(b, hk, nk, bk, d)
    vs = vp.reshape(b, hk, nk, bk, d)
    dq = torch.zeros((b, hk, groups, nq, bq, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for jk in range(nk):
        k_blk = ks[:, :, jk].float()  # (b, hk, bk, d)
        v_blk = vs[:, :, jk].float()
        k_pos = jk * bk + torch.arange(bk, device=dev)
        dk_j = torch.zeros((b, hk, groups, bk, d), dtype=torch.float32, device=dev)
        dv_j = torch.zeros_like(dk_j)
        for iq in range(nq):
            q_blk = qg[:, :, :, iq].float()  # (b, hk, g, bq, d)
            do_blk = dog[:, :, :, iq].float()
            q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk) * scale
            mask = _attn_mask(q_pos, k_pos, causal, window, eff_kv_len)
            lse_blk = lseg[:, :, :, iq]
            lse_safe = torch.where(torch.isfinite(lse_blk), lse_blk, 0.0)
            p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
            dv_j = dv_j + torch.einsum("bkgqc,bkgqd->bkgcd", p, do_blk)
            dp = torch.einsum("bkgqd,bkcd->bkgqc", do_blk, v_blk)
            ds = p * (dp - Dg[:, :, :, iq][..., None]) * scale
            dq[:, :, :, iq] += torch.einsum("bkgqc,bkcd->bkgqd", ds, k_blk)
            dk_j = dk_j + torch.einsum("bkgqc,bkgqd->bkgcd", ds, q_blk)
        dks.append(dk_j)
        dvs.append(dv_j)
    dq = dq.reshape(b, hk, groups, nq * bq, d)[..., :sq, :].reshape(b, h, sq, d)
    dk = torch.stack(dks, dim=2).sum(dim=3)  # (b, hk, nk, bk, d): groups summed once
    dv = torch.stack(dvs, dim=2).sum(dim=3)
    dk = dk.reshape(b, hk, nk * bk, d)[:, :, :skv]
    dv = dv.reshape(b, hk, nk * bk, d)[:, :, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_naive_ref(q, k, v, *, causal=True, window=None, scale=None, q_offset=0,
                  kv_len=None) -> torch.Tensor:
    """O(s^2)-memory attention for tests at small shapes."""
    b, h, sq, d = q.shape
    _, hk, skv, _ = k.shape
    groups = h // hk
    if scale is None:
        scale = 1.0 / (d**0.5)
    kq = torch.repeat_interleave(k, groups, dim=1).float()
    vq = torch.repeat_interleave(v, groups, dim=1).float()
    s = torch.einsum("bhqd,bhcd->bhqc", q.float(), kq) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = _attn_mask(q_pos, k_pos, causal, window, kv_len)
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqc,bhcd->bhqd", p, vq).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD (plain versions of csrc/ssd_scan.cu and of the whole scan)
# ---------------------------------------------------------------------------


def ssd_chunks_ref(
    x: torch.Tensor,  # (bh, nc, T, p) f32
    dt: torch.Tensor,  # (bh, nc, T) f32
    a: torch.Tensor,  # (bh, nc, T) f32 log decays dt*A
    B: torch.Tensor,  # (b, nc*T, g, n) f32, per group
    C: torch.Tensor,  # (b, nc*T, g, n) f32
    *,
    heads: int,
):
    """The SSD intra-chunk block of every (b·h, chunk), as the reference's
    ``_ssd_chunk_kernel`` computes it, with B and C read per group (head
    ``i`` of ``heads`` reads group ``i // (heads // g)``).

    Returns (y_intra (bh, nc, T, p), states (bh, nc, n, p),
    c_decay (bh, nc, T, n), chunk_decay (bh, nc, 1, 1)), all f32.
    """
    bh, nc, T, p = x.shape
    b, _, g, n = B.shape
    rep = heads // g
    group = torch.arange(heads, device=x.device) // rep  # (h,)
    # (b, nc, T, g, n) -> head i's group i // rep -> (b, h, nc, T, n) -> (bh, nc, T, n)
    Bh = B.reshape(b, nc, T, g, n)[:, :, :, group].permute(0, 3, 1, 2, 4)
    Ch = C.reshape(b, nc, T, g, n)[:, :, :, group].permute(0, 3, 1, 2, 4)
    Bh = Bh.reshape(bh, nc, T, n)
    Ch = Ch.reshape(bh, nc, T, n)
    a_cum = torch.cumsum(a, dim=-1)  # (bh, nc, T)
    seg = a_cum[..., :, None] - a_cum[..., None, :]  # (bh, nc, T, T)
    ii = torch.arange(T, device=x.device)
    L = torch.where(ii[:, None] >= ii[None, :], torch.exp(seg), 0.0)
    CB = Ch @ Bh.transpose(-1, -2)  # (bh, nc, T, T)
    M = CB * L * dt[..., None, :]
    y = M @ x
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)  # (bh, nc, T)
    Bw = Bh * (decay_end * dt)[..., None]
    states = Bw.transpose(-1, -2) @ x  # (bh, nc, n, p)
    c_decay = Ch * torch.exp(a_cum)[..., None]
    chunk_decay = torch.exp(a_cum[..., -1])[..., None, None]
    return y, states, c_decay, chunk_decay


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} a[..., k] for j <= i, -inf above."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(T, device=a.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, float("-inf"))


def ssd_scan_ref(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h) positive step sizes
    A: torch.Tensor,  # (h,) negative decay rates
    B: torch.Tensor,  # (b, s, g, n)
    C: torch.Tensor,  # (b, s, g, n)
    *,
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # (b, h, n, p) initial state
    return_state: bool = False,
):
    """Chunked Mamba2 SSD (arXiv:2405.21060), the reference's ``ssd_scan_ref``.

    Recurrence h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t,
    from h_0 = ``h0`` (zeros when None). Returns y (b, s, h, p) in x's
    dtype [and the final state (b, h, n, p) f32].
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bh = torch.repeat_interleave(B.reshape(b, nc, chunk, g, n).float(), rep, dim=3)
    Ch = torch.repeat_interleave(C.reshape(b, nc, chunk, g, n).float(), rep, dim=3)
    a = dtc * A.float()[None, None, None, :]  # (b, nc, T, h)
    a_cum = torch.cumsum(a, dim=2)

    L = torch.exp(_segsum(a.movedim(2, -1)))  # (b, nc, h, T, T)
    CB = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)
    M = CB * L
    y_intra = torch.einsum("bchts,bcsh,bcshp->bcthp", M, dtc, xc)

    decay_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b, nc, T, h)
    states = torch.einsum("bcthn,bcth,bcth,bcthp->bchnp", Bh, decay_end, dtc, xc)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b, nc, h)

    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (b, nc, h, n, p)

    decay_in = torch.exp(a_cum)  # (b, nc, T, h)
    y_state = torch.einsum("bcthn,bcth,bchnp->bcthp", Ch, decay_in, h_prevs)
    y = (y_intra + y_state).reshape(b, S, h, p)[:, :s].to(x.dtype)
    if return_state:
        return y, hprev
    return y


def ssm_decode_step(
    hstate: torch.Tensor,  # (b, h, n, p) f32
    x_t: torch.Tensor,  # (b, h, p)
    dt_t: torch.Tensor,  # (b, h)
    A: torch.Tensor,  # (h,)
    B_t: torch.Tensor,  # (b, g, n)
    C_t: torch.Tensor,  # (b, g, n)
):
    """One recurrent SSD step (the serve step of the SSM archs). Returns
    (new state (b, h, n, p) f32, y (b, h, p) in x_t's dtype)."""
    rep = hstate.shape[1] // B_t.shape[1]
    Bh = torch.repeat_interleave(B_t, rep, dim=1).float()  # (b, h, n)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).float()
    dec = torch.exp(dt_t.float() * A.float()[None, :])  # (b, h)
    upd = dt_t[..., None, None].float() * Bh[..., :, None] * x_t[..., None, :].float()
    h_new = hstate * dec[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, h_new)
    return h_new, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# int8 block codec (plain versions of csrc/int8_codec.cu)
# ---------------------------------------------------------------------------


def int8_quantize_ref(x: torch.Tensor, block: int = 256):
    """Blockwise symmetric int8 quantization of a flat vector, the
    reference's ``int8_quantize_ref``.

    x (n,) is padded with zeros to nb = ceil(n / block) blocks. A block's
    scale is amax/127, or 1 where ``amax > 0`` is false (a zero block, or a
    block holding a NaN: the maximum propagates NaN). amax/127 is taken as
    the reference computes it when compiled: XLA rewrites the division by
    the constant 127 into a product with its f32 reciprocal, under ``jit``
    (the jitted train step) and in the Pallas kernel alike, which is one
    ulp off a true division in about 3% of blocks. q = clip(round(x /
    scale), -127, 127), a true division, rounding half to even; a NaN (a
    NaN element, or any element of a block whose scale is inf) gives 0,
    stated here because a float-to-int8 cast of NaN is not defined.
    Returns (q int8 (nb·block,), scales f32 (nb,)).
    """
    xf = x.reshape(-1).to(torch.float32)
    pad = (-xf.numel()) % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    xb = xf.reshape(-1, block)
    amax = xb.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[:, None]), -127.0, 127.0)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8).reshape(-1), scale


def int8_dequantize_ref(q: torch.Tensor, scale: torch.Tensor, n: int, block: int = 256):
    """q (nb·block,) int8, scale (nb,) f32 -> q·scale, f32 (n,)."""
    nb = scale.shape[0]
    x = q.reshape(nb, block).to(torch.float32) * scale[:, None]
    return x.reshape(-1)[:n]
