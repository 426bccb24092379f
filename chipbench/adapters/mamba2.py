"""The port's config of a ``mamba2`` configuration file: the file's sizes
put into the port's ``LMConfig`` and ``Mamba2Config``."""

import dataclasses


def port_config(cfg: dict, base, **common):
    if not cfg["rms_norm"] or not cfg["tie_embeddings"] or base.norm != "rmsnorm":
        raise ValueError(f"{cfg['arch']}: the port runs tied RMSNorm Mamba2 models")
    d = cfg["d_model"]
    mamba = dataclasses.replace(
        base.mamba_cfg, d_model=d, d_inner=cfg["expand"] * d, d_state=cfg["d_state"],
        head_dim=cfg["headdim"], n_groups=cfg["ngroups"], d_conv=cfg["d_conv"],
        chunk=cfg["chunk_size"])
    return dataclasses.replace(base, d_model=d, n_layers=cfg["n_layer"], mamba_cfg=mamba,
                               **common)
