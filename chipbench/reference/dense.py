"""The ``dense`` family of the plain reference (starcoder2 as the port runs
it): token embedding; per layer LayerNorm, grouped-query attention with
interleaved-pair RoPE and a causal mask, residual, LayerNorm, tanh-GELU
MLP, residual; final LayerNorm; logits against the tied embedding."""

from __future__ import annotations

import torch.nn.functional as F

from chipbench.reference import lm


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, layers=cfg["num_hidden_layers"], vocab=cfg["vocab_size"], h=h,
                hk=cfg["num_key_value_heads"], dh=cfg.get("head_dim") or d // h,
                d_ff=cfg["intermediate_size"])


def param_specs(cfg: dict):
    m = dims(cfg)
    d, hd, kd = m["d"], m["h"] * m["dh"], m["hk"] * m["dh"]
    out = [("embed.table", (m["vocab"], d), "normal")]
    for i in range(m["layers"]):
        pre = f"blocks.{i}."
        out += [(pre + "ln1.scale", (d,), "one_plus_normal"),
                (pre + "ln1.bias", (d,), "normal")]
        for proj, width in (("q", hd), ("k", kd), ("v", kd)):
            out.append((pre + f"attn.{proj}.w", (d, width), "normal"))
            if cfg["qkv_bias"]:
                out.append((pre + f"attn.{proj}.b", (width,), "normal"))
        out += [(pre + "attn.o.w", (hd, d), "normal"),
                (pre + "ln2.scale", (d,), "one_plus_normal"),
                (pre + "ln2.bias", (d,), "normal"),
                (pre + "mlp.up.w", (d, m["d_ff"]), "normal"),
                (pre + "mlp.down.w", (m["d_ff"], d), "normal")]
    return out + [("final_norm.scale", (d,), "one_plus_normal"),
                  ("final_norm.bias", (d,), "normal")]


def layer(cfg, m, p, h, prec, kv_out=None):
    """One layer on h (b, s, d); ``kv_out`` (a list) receives [k, v]."""
    b, s, d = h.shape
    eps, H, Hk, dh = cfg["norm_epsilon"], m["h"], m["hk"], m["dh"]
    x = lm.layer_norm(h, p["ln1.scale"], p["ln1.bias"], eps)

    def proj(name, width):
        y = prec.mm(x, p[f"attn.{name}.w"])
        if cfg["qkv_bias"]:
            y = y + p[f"attn.{name}.b"]
        return y.reshape(b, s, width, dh).transpose(1, 2)  # (b, heads, s, dh)

    q = lm.rope(proj("q", H), cfg["rope_theta"])
    k = lm.rope(proj("k", Hk), cfg["rope_theta"])
    v = proj("v", Hk)
    if kv_out is not None:
        kv_out[:] = [k, v]
    attn = lm.causal_attention(q, k, v, prec).transpose(1, 2).reshape(b, s, H * dh)
    h = h + prec.mm(attn, p["attn.o.w"])
    x = lm.layer_norm(h, p["ln2.scale"], p["ln2.bias"], eps)
    up = F.gelu(prec.mm(x, p["mlp.up.w"]), approximate="tanh")
    return h + prec.mm(up, p["mlp.down.w"])


def final_norm(cfg, params, h):
    return lm.layer_norm(h, params["final_norm.scale"], params["final_norm.bias"],
                         cfg["norm_epsilon"])


def matrix_weights(cfg: dict) -> int:
    """Weights that multiply each token once in the forward, the logits'
    matrix included."""
    m = dims(cfg)
    hd, kd = m["h"] * m["dh"], m["hk"] * m["dh"]
    return m["layers"] * (m["d"] * (2 * hd + 2 * kd) + 2 * m["d"] * m["d_ff"]) \
        + m["vocab"] * m["d"]


def mixer_forward(cfg: dict, b: int, s: int) -> float:
    """Causal attention's QKᵀ and PV in every layer, over the (query, key)
    pairs the causal mask keeps, 2 flops a multiply-add."""
    m = dims(cfg)
    return 4.0 * b * m["h"] * m["dh"] * (s * (s + 1) // 2) * m["layers"]
