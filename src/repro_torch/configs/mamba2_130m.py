"""mamba2-130m [ssm]: 24L d=768, attention-free, ssm_state=128,
vocab=50280 -- SSD (state-space duality). [arXiv:2405.21060]
The reference's ``configs/mamba2_130m.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.lm import LMConfig
from repro_torch.models.mamba2 import Mamba2Config

FULL = LMConfig(
    name="mamba2-130m",
    vocab=50280,
    d_model=768,
    n_layers=24,
    pattern=("mamba",),
    d_ff=0,
    mamba_cfg=Mamba2Config(
        d_model=768, d_inner=1536, d_state=128, head_dim=64, n_groups=1
    ),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    scan_nest=6,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="mamba2-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("mamba",),
    d_ff=0,
    mamba_cfg=Mamba2Config(d_model=64, d_inner=128, d_state=16, head_dim=32, n_groups=1),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="mamba2-130m",
    family="ssm",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=True,
    notes="attention-free SSD -> long_500k runs",
)
