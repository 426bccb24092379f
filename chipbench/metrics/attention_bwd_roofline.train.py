"""The attention backward kernel's share of its roofline in training: each
backward call's least time over the device time of the kernels whose name
holds ``attn_bwd`` (its prep pass, main kernel and conversion). A call's
work is twice the forward launch's operations (dV, dP, dQ and dK over the
causal pairs; S recomputed is not counted, as ``flops.train_step`` counts
training) at the bf16 peak, or its bytes at the memory's rate: twice the
forward's (q, k, v, out and dout read; dq, dk and dv written) and the f32
lse read. A parent without the kernel counts no ``attention_bwd`` launch,
and the reading is None."""

from chipbench import flops, peaks, readers


def work(cfg, b, s):
    ops, n_bytes = flops.attention_launch(cfg, b, s)
    return 2.0 * ops, 2.0 * n_bytes + 4.0 * b * flops.dims(cfg)["h"] * s


def read(rec):
    return readers.roofline(rec, "attention_bwd", "attn_bwd", work, peaks.BF16_OPS_PER_S)
