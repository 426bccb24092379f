"""whisper-medium [audio]: enc-dec, 24+24L d=1024 16H (kv=16) d_ff=4096
vocab=51865 -- conv/mel frontend STUBBED (the batch carries precomputed
frame embeddings). [arXiv:2212.04356]

Shape-cell mapping for the enc-dec family: `seq` applies to the ENCODER
frame axis; decoder token length is capped by max_target_len (448);
decoder positions past it wrap modulo max_target_len.
The reference's ``configs/whisper_medium.py``, with torch dtypes.
"""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.encdec import EncDecConfig

FULL = EncDecConfig(
    name="whisper-medium",
    vocab=51865,
    d_model=1024,
    n_enc_layers=24,
    n_dec_layers=24,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    max_target_len=448,
    norm="layernorm",
    act="gelu",
    dtype=torch.bfloat16,
)

SMOKE = EncDecConfig(
    name="whisper-smoke",
    vocab=256,
    d_model=64,
    n_enc_layers=2,
    n_dec_layers=2,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    max_target_len=64,
    norm="layernorm",
    act="gelu",
    dtype=torch.float32,
)

ARCH = ArchDef(
    arch_id="whisper-medium",
    family="audio",
    full=FULL,
    smoke=SMOKE,
    long_500k_ok=False,
    notes="enc-dec full attention -> long_500k skipped; conv frontend stubbed",
)
