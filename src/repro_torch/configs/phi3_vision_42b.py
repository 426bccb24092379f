"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (kv=32) d_ff=8192 vocab=32064 --
phi3-mini backbone + CLIP frontend. The frontend is a STUB: the batch
carries precomputed patch embeddings (576 patches x 1024-d), linearly
projected and prepended to the tokens.
[hf:microsoft/Phi-3-vision-128k-instruct]
The reference's ``configs/phi3_vision_42b.py``, with torch dtypes."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig, VisionStub

FULL = LMConfig(
    name="phi-3-vision-4.2b",
    vocab=32064,
    d_model=3072,
    n_layers=32,
    pattern=("attn",),
    attn=AttnConfig(d_model=3072, n_heads=32, n_kv_heads=32, d_head=96),
    d_ff=8192,
    mlp_gated=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    vision=VisionStub(n_patches=576, d_vision=1024),
    scan_nest=8,  # 8x4 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="phi3-vision-smoke",
    vocab=256,
    d_model=64,
    n_layers=2,
    pattern=("attn",),
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, d_head=16),
    d_ff=128,
    mlp_gated=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    vision=VisionStub(n_patches=8, d_vision=32),
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="pure full-attention arch -> long_500k skipped; CLIP frontend stubbed",
)
