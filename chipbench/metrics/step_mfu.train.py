"""Model FLOPs of a training step (6 N tokens plus causal attention or the
SSD, counted once: ``flops.train_step``) over the step's device time, as a
percentage of the bf16 tensor-core peak."""

from chipbench import flops, peaks, readers


def read(rec):
    return readers.mfu(rec, flops.train_step, peaks.BF16_OPS_PER_S)
