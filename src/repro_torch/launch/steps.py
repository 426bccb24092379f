"""Step functions of the serving path, the reference's ``launch/steps.py``
(``make_prefill``, ``make_serve_step``; training waits for ROADMAP A9).

PyTorch runs eagerly, so a step is a plain function of (model, inputs);
``impl="ref"`` runs every kernel's plain version instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchDef


def make_prefill(arch: ArchDef, cfg, *, max_cache_len: int, impl: Optional[str] = None):
    def prefill_step(model, batch):
        return arch.prefill(cfg, model, batch, max_cache_len=max_cache_len, impl=impl)

    return prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(b, s, vocab) -> (b, 1) next tokens: argmax of the last position,
    first index on ties (torch.argmax's rule, as jnp.argmax's)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def make_serve_step(arch: ArchDef, cfg, *, impl: Optional[str] = None):
    """One decode step: greedy next token against the caches."""

    def serve_step(model, caches, token):
        caches, logits = arch.decode_step(cfg, model, caches, token, impl=impl)
        return caches, greedy(logits), logits

    return serve_step
