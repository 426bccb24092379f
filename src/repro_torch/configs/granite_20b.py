"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 —
gpt-bigcode family (LayerNorm, GELU, non-gated MLP, MQA). [arXiv:2405.04324]
The reference's ``configs/granite_20b.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="granite-20b",
    vocab=49152,
    d_model=6144,
    n_layers=52,
    pattern=("attn",),
    attn=AttnConfig(d_model=6144, n_heads=48, n_kv_heads=1, d_head=128),
    d_ff=24576,
    mlp_gated=False,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    scan_nest=13,  # 13x4 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="granite-20b-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("attn",),
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=1, d_head=16),
    d_ff=256,
    mlp_gated=False,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="granite-20b",
    family="dense",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped (assignment rule)",
)
