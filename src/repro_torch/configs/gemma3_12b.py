"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 —
5:1 local:global attention (window 1024), scaled embeddings, 128k-class
context. [hf:google/gemma-3-*]

long_500k RUNS for this arch: 5/6 of layers are sliding-window (O(w) per
decode step).
The reference's ``configs/gemma3_12b.py``, with torch dtypes.
"""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="gemma3-12b",
    vocab=262144,
    d_model=3840,
    n_layers=48,
    pattern=("local",) * 5 + ("attn",),  # 8 groups of 5 local + 1 global
    attn=AttnConfig(
        d_model=3840, n_heads=16, n_kv_heads=8, d_head=256, rope_theta=1e6
    ),
    local_window=1024,
    d_ff=15360,
    mlp_gated=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    scan_nest=4,  # 4x2 nested scan remat
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="gemma3-smoke",
    vocab=512,  # tiny embedding table per assignment
    d_model=64,
    n_layers=6,
    pattern=("local",) * 5 + ("attn",),
    attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, rope_theta=1e6),
    local_window=8,
    d_ff=128,
    mlp_gated=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="gemma3-12b",
    family="dense",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=True,
    notes="5:1 local:global -> long_500k runs (local layers sub-quadratic)",
)
