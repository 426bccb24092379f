"""Architecture registry plumbing, the reference's ``configs/base.py``:
shape cells and the ``ArchDef`` adapter over the model entry points.

Every architecture module exports an ``ArchDef`` with a FULL config (the
published spec) and a SMOKE config (same family, tiny dims). ``ArchDef``
routes each entry point to ``models/lm.py`` for an ``LMConfig`` and to
``models/encdec.py`` for an ``EncDecConfig`` (whisper), whose batches carry
``frames``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.models import encdec, lm


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass
class ArchDef:
    """Uniform adapter over the LM and encoder-decoder entry points."""

    arch_id: str
    family: str  # moe | dense | vlm | hybrid | audio | ssm
    full: Any  # LMConfig | EncDecConfig
    smoke: Any
    long_500k_ok: bool
    notes: str = ""

    def is_encdec(self) -> bool:
        return isinstance(self.full, encdec.EncDecConfig)

    def _family(self):
        return encdec if self.is_encdec() else lm

    def init(self, generator: Optional[torch.Generator], cfg=None, *, device=None):
        """Random weights drawn from ``generator`` on ``device`` (the
        generator's device when None); on the meta device, shapes only."""
        cfg = cfg or self.full
        return self._family().init(cfg, generator=generator,
                                   device=generator.device if device is None else device)

    def forward(self, cfg, model, batch, *, impl: Optional[str] = None):
        if self.is_encdec():
            return encdec.forward(cfg, model, batch["frames"], batch["tokens"], impl=impl)
        logits, _ = lm.forward(cfg, model, batch["tokens"], batch.get("images"),
                               impl=impl)
        return logits

    def loss_fn(self, cfg, model, batch, *, impl: Optional[str] = None):
        return self._family().loss_fn(cfg, model, batch, impl=impl)

    def prefill(self, cfg, model, batch, *, max_cache_len: int,
                impl: Optional[str] = None):
        if self.is_encdec():
            return encdec.prefill(cfg, model, batch["frames"], batch["tokens"],
                                  max_cache_len=max_cache_len, impl=impl)
        return lm.prefill(cfg, model, batch["tokens"], max_cache_len=max_cache_len,
                          images=batch.get("images"), impl=impl)

    def init_caches(self, cfg, batch: int, max_len: int, *, device, enc_len: int = 0):
        """Zero decode caches; an encoder-decoder's cross caches hold
        ``enc_len`` frames (``max_len`` when 0, as the reference)."""
        if self.is_encdec():
            return encdec.init_caches(cfg, batch, max_len, enc_len or max_len, device)
        return lm.init_caches(cfg, batch, max_len, device)

    def decode_step(self, cfg, model, caches, token, *, impl: Optional[str] = None):
        return self._family().decode_step(cfg, model, caches, token, impl=impl)

    # ---- input specs (meta tensors, no allocation) ----------------------

    def supports(self, shape_name: str) -> bool:
        if shape_name == "long_500k" and not self.long_500k_ok:
            return False
        return True

    def input_specs(self, shape: Union[str, ShapeCell], cfg=None) -> Dict[str, torch.Tensor]:
        """Model inputs for one shape cell (a name of ``SHAPES`` or a
        ``ShapeCell``), as meta tensors of the reference's shapes and
        dtypes: token ids int32 (the embedding takes them, and
        ``cross_entropy`` widens the labels itself).

        train  -> {tokens, labels[, images|frames]}
        prefill-> {tokens[, images|frames]}
        decode -> {token}   (caches are built separately via init_caches)
        """
        cfg = cfg or self.full
        cell = SHAPES[shape] if isinstance(shape, str) else shape

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if cell.kind == "decode":
            return {"token": meta(cell.batch, 1)}
        if self.is_encdec():
            # seq applies to the encoder frame axis; decoder tokens are
            # bounded by the model's max target length.
            tok_len = min(cell.seq, cfg.max_target_len)
            out = {"frames": meta(cell.batch, cell.seq, cfg.d_model, dtype=torch.bfloat16),
                   "tokens": meta(cell.batch, tok_len)}
            if cell.kind == "train":
                out["labels"] = meta(cell.batch, tok_len)
            return out
        out = {"tokens": meta(cell.batch, cell.seq)}
        if cell.kind == "train":
            out["labels"] = meta(cell.batch, cell.seq)
        if cfg.vision is not None:
            out["images"] = meta(cell.batch, cfg.vision.n_patches, cfg.vision.d_vision,
                                 dtype=torch.bfloat16)
        return out
