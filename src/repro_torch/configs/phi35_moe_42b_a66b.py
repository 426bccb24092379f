"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400/expert,
vocab 32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]
The reference's ``configs/phi35_moe_42b_a66b.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

FULL = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    vocab=32064,
    d_model=4096,
    n_layers=32,
    pattern=("moe",),
    attn=AttnConfig(d_model=4096, n_heads=32, n_kv_heads=8, d_head=128),
    moe_cfg=MoEConfig(d_model=4096, d_expert=6400, n_experts=16, top_k=2),
    norm="layernorm",
    act="silu",
    tie_embeddings=False,
    scan_nest=8,  # 8x4 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="phi35-moe-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("moe",),
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=1, d_head=16),
    moe_cfg=MoEConfig(d_model=64, d_expert=96, n_experts=4, top_k=2),
    norm="layernorm",
    act="silu",
    tie_embeddings=False,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped (assignment rule)",
)
