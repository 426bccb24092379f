"""The ``mamba2`` family of the plain reference: per layer RMSNorm, then the
Mamba2 block (arXiv:2405.21060): one input projection to [z | x B C | dt],
a causal depthwise conv of width ``d_conv`` with SiLU over (x, B, C),
dt = softplus(dt + dt_bias), A = -exp(A_log), the SSD scan, the D skip,
RMSNorm gated by SiLU(z), the output projection, residual; final RMSNorm;
logits against the tied embedding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chipbench.reference import lm


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    d_inner = cfg["expand"] * d
    heads = d_inner // cfg["headdim"]
    gn = cfg["ngroups"] * cfg["d_state"]
    return dict(d=d, layers=cfg["n_layer"], vocab=cfg["vocab_size"], d_inner=d_inner,
                heads=heads, p=cfg["headdim"], g=cfg["ngroups"], n=cfg["d_state"],
                conv_ch=d_inner + 2 * gn, d_in_proj=2 * d_inner + 2 * gn + heads,
                d_conv=cfg["d_conv"])


def param_specs(cfg: dict):
    m = dims(cfg)
    d = m["d"]
    out = [("embed.table", (m["vocab"], d), "normal")]
    for i in range(m["layers"]):
        pre = f"blocks.{i}."
        out += [(pre + "ln.scale", (d,), "one_plus_normal"),
                (pre + "mamba.in_proj.w", (d, m["d_in_proj"]), "normal"),
                (pre + "mamba.conv_w", (m["d_conv"], m["conv_ch"]), "normal"),
                (pre + "mamba.conv_b", (m["conv_ch"],), "normal"),
                (pre + "mamba.dt_bias", (m["heads"],), "dt_bias"),
                (pre + "mamba.A_log", (m["heads"],), "a_log"),
                (pre + "mamba.D", (m["heads"],), "one_plus_normal_f32"),
                (pre + "mamba.norm_scale", (m["d_inner"],), "one_plus_normal"),
                (pre + "mamba.out_proj.w", (m["d_inner"], d), "normal")]
    return out + [("final_norm.scale", (d,), "one_plus_normal")]


def _segsum(a):
    """out[..., i, j] = a[..., j+1] + ... + a[..., i] for j <= i, -inf
    above; summed directly, never as a difference of running sums."""
    T = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, T)  # x[..., i, j] = a_i
    below = torch.ones((T, T), dtype=torch.bool, device=a.device).tril(-1)
    x = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    on_or_below = torch.ones((T, T), dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~on_or_below, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ,
    y_t = C_t h_t from h_0 = 0, in chunks (the minimal chunked form of
    arXiv:2405.21060). x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s,
    g, n); head i reads group i // (h / g). Returns y (b, s, h, p)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    nc = x.shape[1] // chunk
    rep = h // g
    X = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    a = (dt * A).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    a_cum = torch.cumsum(a, dim=-1)
    Bg = B.reshape(b, nc, chunk, g, n)
    Cg = C.reshape(b, nc, chunk, g, n)
    CB = torch.einsum("bclgn,bcsgn->bgcls", Cg, Bg).repeat_interleave(rep, dim=1)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * torch.exp(_segsum(a)), X)
    Bh, Ch = Bg.repeat_interleave(rep, dim=3), Cg.repeat_interleave(rep, dim=3)
    decay = torch.exp(a_cum[..., -1:] - a_cum)  # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # (b, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]


def layer(cfg, m, p, h, prec, kv_out=None):
    b, s, _ = h.shape
    eps = cfg["norm_epsilon"]
    x = lm.rms_norm(h, p["ln.scale"], eps)
    z, xbc, dt = torch.split(prec.mm(x, p["mamba.in_proj.w"]),
                             [m["d_inner"], m["conv_ch"], m["heads"]], dim=-1)
    w = p["mamba.conv_w"]  # (d_conv, channels): tap i reads position t - (d_conv - 1) + i
    xp = F.pad(xbc, (0, 0, m["d_conv"] - 1, 0))
    conv = sum(xp[:, i:i + s] * w[i] for i in range(m["d_conv"]))
    xbc = F.silu(conv + p["mamba.conv_b"])
    gn = m["g"] * m["n"]
    xs, Bm, Cm = torch.split(xbc, [m["d_inner"], gn, gn], dim=-1)
    dt = F.softplus(dt + p["mamba.dt_bias"])
    A = -torch.exp(p["mamba.A_log"])
    xh = xs.reshape(b, s, m["heads"], m["p"])
    y = ssd(xh, dt, A, Bm.reshape(b, s, m["g"], m["n"]), Cm.reshape(b, s, m["g"], m["n"]),
            cfg["chunk_size"])
    y = (y + p["mamba.D"][:, None] * xh).reshape(b, s, m["d_inner"])
    y = lm.rms_norm(y * F.silu(z), p["mamba.norm_scale"], eps)
    return h + prec.mm(y, p["mamba.out_proj.w"])


def final_norm(cfg, params, h):
    return lm.rms_norm(h, params["final_norm.scale"], cfg["norm_epsilon"])


def matrix_weights(cfg: dict) -> int:
    """Weights that multiply each token once in the forward: in_proj, the
    conv's taps, out_proj, and the logits' matrix."""
    m = dims(cfg)
    layer = m["d"] * m["d_in_proj"] + m["d_conv"] * m["conv_ch"] + m["d_inner"] * m["d"]
    return m["layers"] * layer + m["vocab"] * m["d"]


def mixer_forward(cfg: dict, b: int, s: int) -> float:
    """The chunked SSD of every layer: C Bᵀ a group and M x a head on each
    chunk's causal triangle, each chunk's state and its read-out, and the
    state passed between chunks."""
    m = dims(cfg)
    T = cfg["chunk_size"]
    nc = -(-s // T)
    tri, n, p = T * (T + 1) // 2, m["n"], m["p"]
    chunk = 2.0 * m["g"] * tri * n + m["heads"] * (2.0 * tri * p + 4.0 * T * n * p + 2.0 * n * p)
    return b * nc * chunk * m["layers"]
