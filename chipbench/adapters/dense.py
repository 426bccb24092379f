"""The port's config of a ``dense`` configuration file (starcoder2's
shape): the file's sizes put into the port's ``LMConfig``."""

import dataclasses


def port_config(cfg: dict, base, **common):
    want = (cfg["norm_type"], cfg["hidden_act"], cfg["tie_word_embeddings"])
    if want != ("layer_norm", "gelu_pytorch_tanh", True) or base.norm != "layernorm" \
            or base.act != "gelu" or base.mlp_gated or cfg.get("use_bias"):
        raise ValueError(f"{cfg['arch']}: the port runs tied LayerNorm, tanh-GELU, "
                         f"ungated MLPs without biases; the file states {want}")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    attn = dataclasses.replace(
        base.attn, d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        d_head=cfg.get("head_dim") or d // h, rope_theta=float(cfg["rope_theta"]),
        qkv_bias=bool(cfg["qkv_bias"]), window=None)
    return dataclasses.replace(base, d_model=d, n_layers=cfg["num_hidden_layers"], attn=attn,
                               d_ff=cfg["intermediate_size"], **common)
