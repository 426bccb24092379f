"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) d_ff=512/expert,
vocab 49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
The reference's ``configs/granite_moe_1b_a400m.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

FULL = LMConfig(
    name="granite-moe-1b-a400m",
    vocab=49155,
    d_model=1024,
    n_layers=24,
    pattern=("moe",),
    attn=AttnConfig(d_model=1024, n_heads=16, n_kv_heads=8, d_head=64),
    moe_cfg=MoEConfig(d_model=1024, d_expert=512, n_experts=32, top_k=8),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    scan_nest=6,  # 6x4 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="granite-moe-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("moe",),
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16),
    moe_cfg=MoEConfig(d_model=64, d_expert=32, n_experts=4, top_k=2),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped (assignment rule)",
)
