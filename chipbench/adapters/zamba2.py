"""The port's config of a ``zamba2`` configuration file (Zamba2-7B's
published layout): the file's sizes put into the port's
``configs.zamba2_7b.PUBLISHED``. The arch's registered config (``base``)
is the JAX package's layout of zamba2, not this one, and is not used."""

import dataclasses

# what the port's published layout runs, by the file's keys
LAYOUT = {"hidden_act": "gelu", "add_bias_linear": False, "use_conv_bias": True,
          "use_mem_rope": True, "use_long_context": False, "use_shared_mlp_adapter": True,
          "use_shared_attention_adapter": False, "time_step_limit": None,
          "tie_word_embeddings": True}


def port_config(cfg: dict, base, **common):
    from repro_torch.configs import zamba2_7b

    got = {k: cfg[k] for k in LAYOUT}
    hybrid = tuple(cfg["hybrid_layer_ids"])
    kinds = ["hybrid" if i in hybrid else "mamba" for i in range(cfg["num_hidden_layers"])]
    if got != LAYOUT or cfg["layers_block_type"] != kinds \
            or cfg["intermediate_size"] != cfg["ffn_hidden_size"]:
        raise ValueError(f"{cfg['arch']}: the port runs {LAYOUT}, with layers_block_type "
                         f"hybrid at hybrid_layer_ids; the file states {got}")
    d, ff = cfg["hidden_size"], cfg["ffn_hidden_size"]
    pub = zamba2_7b.PUBLISHED
    attn = dataclasses.replace(
        pub.attn, d_model=d, n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["attention_head_dim"],
        d_in=cfg["attention_hidden_size"], scale=(cfg["attention_head_dim"] / 2) ** -0.5,
        rope_theta=float(cfg["rope_theta"]))
    mamba = dataclasses.replace(
        pub.mamba_cfg, d_model=d, d_inner=cfg["mamba_expand"] * d, d_state=cfg["mamba_d_state"],
        head_dim=cfg["mamba_headdim"], n_groups=cfg["mamba_ngroups"],
        norm_groups=cfg["mamba_ngroups"], d_conv=cfg["mamba_d_conv"], chunk=cfg["chunk_size"])
    return dataclasses.replace(pub, d_model=d, n_layers=cfg["num_hidden_layers"], attn=attn,
                               d_ff=ff, mamba_cfg=mamba, hybrid_layers=hybrid,
                               n_shared_blocks=cfg["num_mem_blocks"],
                               adapter_rank=cfg["adapter_rank"], **common)
