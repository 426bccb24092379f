"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=49152 vocab=152064 —
llama-family with QKV bias (the Qwen1.5 signature). [hf:Qwen/Qwen1.5-*]
The reference's ``configs/qwen15_110b.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="qwen1.5-110b",
    vocab=152064,
    d_model=8192,
    n_layers=80,
    pattern=("attn",),
    attn=AttnConfig(
        d_model=8192, n_heads=64, n_kv_heads=8, d_head=128, qkv_bias=True,
        rope_theta=1e6,
    ),
    d_ff=49152,
    mlp_gated=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    scan_nest=10,  # 10x8 nested scan: remat boundaries 80 -> 18 (see §Perf)
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="qwen15-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("attn",),
    attn=AttnConfig(
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16, qkv_bias=True, rope_theta=1e6
    ),
    d_ff=192,
    mlp_gated=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="qwen1.5-110b",
    family="dense",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped (assignment rule)",
)
