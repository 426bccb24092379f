"""Example LM configs for the serving CLI, the reference's
``configs/example_lm.py``: ``100m`` is the ~100M-parameter example model,
``10m`` its CPU-budget variant (same code path, smaller dims)."""

import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnConfig
from repro_torch.models.lm import LMConfig


def _lm(name, layers, d, heads, kv, ff, vocab):
    return LMConfig(
        name=name,
        vocab=vocab,
        d_model=d,
        n_layers=layers,
        pattern=("attn",),
        attn=AttnConfig(d_model=d, n_heads=heads, n_kv_heads=kv, d_head=d // heads),
        d_ff=ff,
        mlp_gated=True,
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        dtype=torch.float32,
    )


LM_100M = _lm("example-100m", layers=12, d=768, heads=12, kv=4, ff=2048, vocab=32768)
LM_10M = _lm("example-10m", layers=6, d=256, heads=8, kv=4, ff=1024, vocab=8192)

EXAMPLES = {"100m": LM_100M, "10m": LM_10M}

ARCH_100M = ArchDef(
    arch_id="example-100m", family="dense", full=LM_100M, smoke=LM_10M,
    long_500k_ok=False,
)
