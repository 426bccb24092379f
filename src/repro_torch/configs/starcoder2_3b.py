"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 --
RoPE, LayerNorm, GELU, non-gated MLP, QKV bias. [arXiv:2402.19173]
The reference's ``configs/starcoder2_3b.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="starcoder2-3b",
    vocab=49152,
    d_model=3072,
    n_layers=30,
    pattern=("attn",),
    attn=AttnConfig(
        d_model=3072, n_heads=24, n_kv_heads=2, d_head=128, qkv_bias=True
    ),
    d_ff=12288,
    mlp_gated=False,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="starcoder2-smoke",
    vocab=256,
    d_model=48,
    n_layers=2,
    pattern=("attn",),
    attn=AttnConfig(d_model=48, n_heads=3, n_kv_heads=1, d_head=16, qkv_bias=True),
    d_ff=192,
    mlp_gated=False,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="starcoder2-3b",
    family="dense",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped",
)
