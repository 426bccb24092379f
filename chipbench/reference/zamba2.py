"""The ``zamba2`` family of the plain reference: Zyphra's Zamba2 (the
published Zamba2-7B-Instruct; transformers' ``modeling_zamba2``), written
from the configuration file's published keys.

Every layer is a Mamba2 layer: h + Mamba2(RMSNorm(x)). At the
``hybrid_layer_ids`` (call c, the index among them) the layer first calls
shared block j = c mod ``num_mem_blocks`` on concat(h, h0), h0 the
embedding's output:

    x = RMSNorm(concat(h, h0))                       2d wide
    q, k, v = x W{q,k,v}, heads of ``attention_head_dim``, RoPE on q and k
    a = softmax(q kᵀ (dh / 2)^-1/2, causal) v W_o    back to d
    y = RMSNorm(a)
    u = y W_gate_up + (y A_c) B_c                    the call's adapter
    t = (GELU(u[:d_ff]) ⊙ u[d_ff:]) W_down L_i       exact GELU; L_i the layer's linear

and its Mamba2 input is x = h + t (the residual stays h). Without a hybrid
call x = h. The Mamba2 block is ``reference/mamba2.py``'s but for its gated
RMSNorm, which normalises each of the ``mamba_ngroups`` groups of channels
apart. Final RMSNorm; logits against the tied embedding.

Departures from the published model (the configuration's ``assumed``):
RoPE rotates interleaved pairs where transformers rotates halves (a fixed
permutation of q's and k's features); every RMSNorm, the gated one too,
takes the file's ``norm_epsilon`` (transformers' gated norm takes 1e-5);
dt is not clamped (``time_step_limit`` null).

The shared blocks' tensors are listed once (``shared.{j}.*``); the
``layer_params`` hook hands each hybrid layer its block's tensors under
``shared.*``, besides its own ``blocks.{i}.*`` slice, which holds the
call's adapter (``adapter_in``, ``adapter_out``) and ``linear``. A hybrid
layer fills ``kv_out`` with its call's k (after RoPE) and v.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference import lm, mamba2

READS_H0 = True


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    d_inner = cfg["mamba_expand"] * d
    heads = d_inner // cfg["mamba_headdim"]
    gn = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    h, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    if heads != cfg["n_mamba_heads"] or not h * dh == cfg["attention_hidden_size"] == 2 * d:
        raise ValueError(f"{cfg['arch']}: inconsistent widths")
    return dict(d=d, layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"],
                d_inner=d_inner, heads=heads, p=cfg["mamba_headdim"], g=cfg["mamba_ngroups"],
                n=cfg["mamba_d_state"], conv_ch=d_inner + 2 * gn,
                d_in_proj=2 * d_inner + 2 * gn + heads, d_conv=cfg["mamba_d_conv"],
                h=h, hk=cfg["num_key_value_heads"], dh=dh, d_ff=cfg["ffn_hidden_size"],
                rank=cfg["adapter_rank"], hybrid=tuple(cfg["hybrid_layer_ids"]),
                blocks=cfg["num_mem_blocks"])


def param_specs(cfg: dict):
    m = dims(cfg)
    d, hd, kd = m["d"], m["h"] * m["dh"], m["hk"] * m["dh"]
    out = [("embed.table", (m["vocab"], d), "normal")]
    for j in range(m["blocks"]):
        pre = f"shared.{j}."
        out += [(pre + "ln1.scale", (2 * d,), "one_plus_normal"),
                (pre + "attn.q.w", (2 * d, hd), "normal"),
                (pre + "attn.k.w", (2 * d, kd), "normal"),
                (pre + "attn.v.w", (2 * d, kd), "normal"),
                (pre + "attn.o.w", (hd, d), "normal"),
                (pre + "ln2.scale", (d,), "one_plus_normal"),
                (pre + "gate_up.w", (d, 2 * m["d_ff"]), "normal"),
                (pre + "down.w", (m["d_ff"], d), "normal")]
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
        if i in m["hybrid"]:
            out += [(pre + "adapter_in.w", (d, m["rank"]), "normal"),
                    (pre + "adapter_out.w", (m["rank"], 2 * m["d_ff"]), "normal"),
                    (pre + "linear.w", (d, d), "normal")]
    return out + [("final_norm.scale", (d,), "one_plus_normal")]


def layer_params(params, i: int):
    """Layer ``i``'s slice, and for a hybrid layer (one with a ``linear``)
    its shared block's tensors under ``shared.*``: call c is the number of
    hybrid layers before it, its block c mod the number of blocks."""
    p = lm._layer_params(params, i)
    if "linear.w" in p:
        call = sum(f"blocks.{k}.linear.w" in params for k in range(i))
        blocks = len({name.split(".")[1] for name in params if name.startswith("shared.")})
        pre = f"shared.{call % blocks}."
        p.update({"shared." + k[len(pre):]: v for k, v in params.items() if k.startswith(pre)})
    return p


def _shared_block(cfg, m, p, h, h0, prec, kv_out):
    """The shared block's output t, through the layer's linear."""
    b, s, _ = h.shape
    eps, H, Hk, dh = cfg["norm_epsilon"], m["h"], m["hk"], m["dh"]
    x = lm.rms_norm(torch.cat([h, h0], dim=-1), p["shared.ln1.scale"], eps)

    def proj(name, width):
        return prec.mm(x, p[f"shared.attn.{name}.w"]).reshape(b, s, width, dh).transpose(1, 2)

    q = lm.rope(proj("q", H), cfg["rope_theta"])
    k = lm.rope(proj("k", Hk), cfg["rope_theta"])
    v = proj("v", Hk)
    if kv_out is not None:
        kv_out[:] = [k, v]
    # lm.causal_attention scales by dh^-1/2: q times 2^1/2 gives (dh / 2)^-1/2
    attn = lm.causal_attention(q * math.sqrt(2.0), k, v, prec)
    y = lm.rms_norm(prec.mm(attn.transpose(1, 2).reshape(b, s, H * dh), p["shared.attn.o.w"]),
                    p["shared.ln2.scale"], eps)
    u = prec.mm(y, p["shared.gate_up.w"]) + prec.mm(prec.mm(y, p["adapter_in.w"]),
                                                     p["adapter_out.w"])
    gate, up = torch.split(u, [m["d_ff"], m["d_ff"]], dim=-1)
    return prec.mm(prec.mm(F.gelu(gate) * up, p["shared.down.w"]), p["linear.w"])


def _mamba(cfg, m, p, x, prec):
    """The Mamba2 block on its normed input x (b, s, d)."""
    b, s, _ = x.shape
    z, xbc, dt = torch.split(prec.mm(x, p["mamba.in_proj.w"]),
                             [m["d_inner"], m["conv_ch"], m["heads"]], dim=-1)
    w = p["mamba.conv_w"]  # (d_conv, channels): tap i reads position t - (d_conv - 1) + i
    xp = F.pad(xbc, (0, 0, m["d_conv"] - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + s] * w[i] for i in range(m["d_conv"])) + p["mamba.conv_b"])
    gn = m["g"] * m["n"]
    xs, Bm, Cm = torch.split(xbc, [m["d_inner"], gn, gn], dim=-1)
    dt = F.softplus(dt + p["mamba.dt_bias"])
    A = -torch.exp(p["mamba.A_log"])
    xh = xs.reshape(b, s, m["heads"], m["p"])
    y = mamba2.ssd(xh, dt, A, Bm.reshape(b, s, m["g"], m["n"]),
                   Cm.reshape(b, s, m["g"], m["n"]), cfg["chunk_size"])
    y = (y + p["mamba.D"][:, None] * xh).reshape(b, s, m["d_inner"]) * F.silu(z)
    y = lm.rms_norm(y.unflatten(-1, (m["g"], -1)), 1.0, cfg["norm_epsilon"]).flatten(-2)
    return prec.mm(y * p["mamba.norm_scale"], p["mamba.out_proj.w"])


def layer(cfg, m, p, h, prec, kv_out=None, *, h0):
    """One layer on h (b, s, d); a hybrid layer's ``kv_out`` (a list)
    receives its call's [k, v]."""
    x = h + _shared_block(cfg, m, p, h, h0, prec, kv_out) if "linear.w" in p else h
    return h + _mamba(cfg, m, p, lm.rms_norm(x, p["ln.scale"], cfg["norm_epsilon"]), prec)


def final_norm(cfg, params, h):
    return lm.rms_norm(h, params["final_norm.scale"], cfg["norm_epsilon"])


def matrix_weights(cfg: dict) -> int:
    """Weights that multiply each token once in the forward: every layer's
    in_proj, conv taps and out_proj; at every hybrid call its block's q, k,
    v, o, gate-up and down, the call's adapter and linear (a shared block's
    once a call); and the logits' matrix."""
    m = dims(cfg)
    d, hd, kd, ff = m["d"], m["h"] * m["dh"], m["hk"] * m["dh"], m["d_ff"]
    mamba_layer = d * m["d_in_proj"] + m["d_conv"] * m["conv_ch"] + m["d_inner"] * d
    call = (2 * d * (hd + 2 * kd) + hd * d + 3 * d * ff + m["rank"] * (d + 2 * ff) + d * d)
    return m["layers"] * mamba_layer + len(m["hybrid"]) * call + m["vocab"] * d


def mixer_forward(cfg: dict, b: int, s: int) -> float:
    """The chunked SSD of every layer (as ``reference/mamba2.py`` counts it)
    and causal attention's QKᵀ and PV at every hybrid call."""
    m = dims(cfg)
    T = cfg["chunk_size"]
    tri, n, p = T * (T + 1) // 2, m["n"], m["p"]
    chunk = 2.0 * m["g"] * tri * n + m["heads"] * (2.0 * tri * p + 4.0 * T * n * p + 2.0 * n * p)
    ssd = b * -(-s // T) * chunk * m["layers"]
    return ssd + 4.0 * b * m["h"] * m["dh"] * (s * (s + 1) // 2) * len(m["hybrid"])
