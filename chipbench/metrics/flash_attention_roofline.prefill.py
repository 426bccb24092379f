"""The flash-attention kernel's share of its roofline in prefill: each
launch's least time (causal QK^T and PV at the bf16 peak, or q, k, v
read and the output written at the memory's rate) over the kernels'
device time."""

from chipbench import flops, peaks, readers


def read(rec):
    return readers.roofline(rec, "flash_attention", "flash_", flops.attention_launch,
                            peaks.BF16_OPS_PER_S)
