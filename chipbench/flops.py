"""Operations and bytes, computed from a configuration's published widths
and a cell's shapes, whatever implementation runs.

Model FLOPs (for ``*mfu*``) count each product the model needs once: 2 a
multiply-add of every weight matrix (the tied embedding as the logits'
matrix, the depthwise conv's taps), causal attention's QKᵀ and PV over the
(query, key) pairs a causal mask keeps, and the SSD's products on the
causal triangle of each chunk; training is three times the forward (the
backward's two products for each of the forward's), with no recomputation.
Norms, activations and the optimizer are left out.

A kernel launch's work (for ``*_roofline``) is what its inputs need: its
operations as above, and each input byte read once and each output byte
written once.
"""

from __future__ import annotations

from chipbench import peaks
from chipbench.reference import lm
from chipbench.reference.lm import dims


def matrix_weights(cfg: dict) -> int:
    """Weights that multiply each token once in the forward, the logits'
    matrix included."""
    return lm.family(cfg).matrix_weights(cfg)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def mixer_forward(cfg: dict, b: int, s: int) -> float:
    """The sequence mixer's products in every layer (attention, the SSD)."""
    return lm.family(cfg).mixer_forward(cfg, b, s)


def train_step(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one training step on b sequences of s tokens."""
    return 3.0 * (2.0 * matrix_weights(cfg) * b * s + mixer_forward(cfg, b, s))


def prefill(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of prefilling b prompts of s tokens: every layer on every
    position, the logits on the last position only."""
    m = dims(cfg)
    layers = matrix_weights(cfg) - m["vocab"] * m["d"]
    return 2.0 * layers * b * s + mixer_forward(cfg, b, s) + 2.0 * m["vocab"] * m["d"] * b


def attention_launch(cfg: dict, b: int, s: int, elem_bytes: int = 2):
    """(operations, bytes) of one causal self-attention launch of one
    layer: q (b, h, s, dh), k and v (b, hk, s, dh) read, out written."""
    m = dims(cfg)
    ops = 4.0 * b * m["h"] * m["dh"] * causal_pairs(s)
    n_bytes = elem_bytes * (2 * b * m["h"] * s * m["dh"] + 2 * b * m["hk"] * s * m["dh"])
    return ops, n_bytes


def ssd_chunks_launch(cfg: dict, b: int, s: int):
    """(operations, bytes) of one ``ssd_chunks`` launch of one layer, all
    f32: x, dt, dt*A per (b*h, chunk) and B, C per group read; the intra-
    chunk output, the chunk states, C times its decay and the chunk decays
    written."""
    m = dims(cfg)
    T = cfg["chunk_size"]
    nc = -(-s // T)
    h, g, n, p = m["heads"], m["g"], m["n"], m["p"]
    tri = causal_pairs(T)
    ops = b * nc * (2.0 * g * tri * n + h * (2.0 * tri * p + 2.0 * T * n * p))
    n_bytes = 4.0 * (b * h * nc * T * (p + 2) + 2 * b * nc * T * g * n
                     + b * h * nc * (T * p + n * p + T * n + 1))
    return ops, n_bytes


def bound_s(ops: float, n_bytes: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the operations
    at ``ops_per_s`` and the bytes at the memory's rate."""
    return max(ops / ops_per_s, n_bytes / peaks.HBM_BYTES_PER_S)
