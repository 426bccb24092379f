"""Model FLOPs of a prefill batch (the logits on the last position only:
``flops.prefill``) over the batch's device time, as a percentage of the
bf16 tensor-core peak."""

from chipbench import flops, peaks, readers


def read(rec):
    return readers.mfu(rec, flops.prefill, peaks.BF16_OPS_PER_S)
