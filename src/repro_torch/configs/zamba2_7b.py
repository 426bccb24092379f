"""zamba2-7b [hybrid]: 81L d=3584 (Mamba2 backbone, ssm_state=64) + a
weight-SHARED attention block (32H, d_ff=14336) invoked once per 3-layer
group -- the Zamba2 signature. vocab=32000. [arXiv:2411.15242]

long_500k RUNS: the Mamba2 backbone is O(1)-state per decode step.
The reference's ``configs/zamba2_7b.py``, with torch dtypes.

``PUBLISHED`` is Zyphra's Zamba2-7B-Instruct as its config.json gives it,
a second configuration of the same arch on the same code path (not a
registry entry): 81 Mamba2 layers (112 heads of 64, state 64, 2 groups,
the gated norm in 2 groups); at the 13 hybrid layers one of two shared
blocks, in turn, of 32 heads of 224 over the 7,168-wide concat(h, h0),
softmax scale (224 / 2)^-1/2, exact-GELU gated MLP of 14,336 with a
rank-128 adapter a call; 7,356,749,648 weights. Its norms take eps 1e-6
(published 1e-5) and its SSD chunks of 128 (256): the port's.
``PUBLISHED_SMOKE`` is the same layout at tiny widths.
"""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig, WideAttnConfig
from repro_torch.models.lm import HybridLMConfig, LMConfig
from repro_torch.models.mamba2 import GroupedNormMamba2Config, Mamba2Config

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

PUBLISHED = HybridLMConfig(
    name="zamba2-7b",
    vocab=32000,
    d_model=3584,
    n_layers=81,
    pattern=("mamba",),
    attn=WideAttnConfig(d_model=3584, n_heads=32, n_kv_heads=32, d_head=224, d_in=7168,
                        scale=112**-0.5),
    d_ff=14336,
    mamba_cfg=GroupedNormMamba2Config(d_model=3584, d_inner=7168, d_state=64, head_dim=64,
                                      n_groups=2, norm_groups=2),
    shared_attn=True,
    norm="rmsnorm",
    act="gelu_erf",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    hybrid_layers=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_shared_blocks=2,
    adapter_rank=128,
)

PUBLISHED_SMOKE = HybridLMConfig(
    name="zamba2-7b",
    vocab=256,
    d_model=64,
    n_layers=8,
    pattern=("mamba",),
    attn=WideAttnConfig(d_model=64, n_heads=4, n_kv_heads=4, d_head=32, d_in=128,
                        scale=16**-0.5),
    d_ff=128,
    mamba_cfg=GroupedNormMamba2Config(d_model=64, d_inner=128, d_state=16, head_dim=32,
                                      n_groups=2, norm_groups=2, chunk=16),
    shared_attn=True,
    norm="rmsnorm",
    act="gelu_erf",
    tie_embeddings=True,
    dtype=torch.float32,
    hybrid_layers=(1, 3, 6),
    n_shared_blocks=2,
    adapter_rank=8,
)

ARCH = ArchDef(
    arch_id="zamba2-7b",
    family="hybrid",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=True,
    notes="Mamba2 + shared attention hybrid -> long_500k runs (SSM state O(1))",
)
