"""Deterministic synthetic data pipeline with checkpointable state, a copy
of the reference's ``data/pipeline.py`` (numpy only; the port imports
nothing of the reference, so it keeps its own copy, batch for batch
equal to the reference's).

Produces LM token batches (plus frames/images for the audio/vlm families)
from a counter-based PRNG: batch `i` is a pure function of (seed, i), so
  * restarts resume exactly (the pipeline state is one integer),
  * every data-parallel host can slice its shard without coordination,
  * straggler mitigation can re-issue a batch elsewhere deterministically.

The token stream is Zipf-distributed with a Markov bigram twist so the loss
has learnable structure (used by the convergence/integration tests and the
~100M-param example run).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    n_frames: int = 0  # audio frames (enc-dec)
    d_frame: int = 0
    n_patches: int = 0  # vlm patches
    d_vision: int = 0


class SyntheticPipeline:
    """state = next batch index. `batch_at(i)` is pure; `next()` advances."""

    def __init__(self, cfg: PipelineConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        assert cfg.global_batch % n_hosts == 0
        self.local_batch = cfg.global_batch // n_hosts
        self.step = 0

    # -- deterministic generation ----------------------------------------

    def _rng(self, step: int, host: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, host])
        )

    def _tokens(self, rng, batch: int):
        cfg = self.cfg
        # Zipf marginals + bigram structure: t_{i+1} ~ (t_i * 31 + z) mod V
        z = rng.zipf(1.3, size=(batch, cfg.seq)).astype(np.int64)
        z = np.minimum(z, cfg.vocab - 1)
        toks = np.empty((batch, cfg.seq), np.int64)
        toks[:, 0] = z[:, 0]
        for t in range(1, cfg.seq):
            structured = (toks[:, t - 1] * 31 + 7) % cfg.vocab
            use_struct = rng.random(batch) < 0.7
            toks[:, t] = np.where(use_struct, structured, z[:, t])
        return toks.astype(np.int32)

    def batch_at(self, step: int, host: Optional[int] = None):
        host = self.host_id if host is None else host
        rng = self._rng(step, host)
        cfg = self.cfg
        toks = self._tokens(rng, self.local_batch)
        out = {
            "tokens": toks,
            "labels": np.roll(toks, -1, axis=1),
        }
        if cfg.n_frames:
            out["frames"] = rng.normal(
                0, 1, (self.local_batch, cfg.n_frames, cfg.d_frame)
            ).astype(np.float32)
        if cfg.n_patches:
            out["images"] = rng.normal(
                0, 1, (self.local_batch, cfg.n_patches, cfg.d_vision)
            ).astype(np.float32)
        return out

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    next = __next__

    # -- checkpointable state ---------------------------------------------

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, state):
        self.step = int(state["step"])
