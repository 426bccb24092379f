"""The flash-attention kernel's share of its roofline in training: each
launch's least time (causal QK^T and PV at the bf16 peak, or q, k, v
read and the output written at the memory's rate) over the kernels'
device time. It launches twice a layer, each time writing lse: in the
forward and in its recomputation for the backward, whose kernel
(``attention_bwd``) reads the saved (out, lse)."""

from chipbench import flops, peaks, readers


def read(rec):
    return readers.roofline(rec, "flash_attention", "flash_", flops.attention_launch,
                            peaks.BF16_OPS_PER_S)
