"""zamba2-7b [hybrid]: 81L d=3584 (Mamba2 backbone, ssm_state=64) + a
weight-SHARED attention block (32H, d_ff=14336) invoked once per 3-layer
group -- the Zamba2 signature. vocab=32000. [arXiv:2411.15242]

long_500k RUNS: the Mamba2 backbone is O(1)-state per decode step.
The reference's ``configs/zamba2_7b.py``, with torch dtypes.
"""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.mamba2 import Mamba2Config

FULL = LMConfig(
    name="zamba2-7b",
    vocab=32000,
    d_model=3584,
    n_layers=81,
    pattern=("mamba",) * 3,  # 27 groups; shared attn applied per group
    attn=AttnConfig(d_model=3584, n_heads=32, n_kv_heads=32, d_head=112),
    d_ff=14336,
    mamba_cfg=Mamba2Config(
        d_model=3584, d_inner=7168, d_state=64, head_dim=64, n_groups=2
    ),
    shared_attn=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scan_nest=9,  # 9x3 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="zamba2-smoke",
    vocab=256,
    d_model=64,
    n_layers=6,
    pattern=("mamba",) * 3,
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, d_head=16),
    d_ff=128,
    mamba_cfg=Mamba2Config(d_model=64, d_inner=128, d_state=16, head_dim=32, n_groups=1),
    shared_attn=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="zamba2-7b",
    family="hybrid",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=True,
    notes="Mamba2 + shared attention hybrid -> long_500k runs (SSM state O(1))",
)
