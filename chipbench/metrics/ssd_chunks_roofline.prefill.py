"""The ssd_chunks kernel's share of its roofline in prefill: each launch's
least time (its f32 products at the TF32 tensor-core peak, which bounds
f32-exact work done as 3xTF32 too, or its f32 inputs read and outputs
written at the memory's rate) over the kernel's device time."""

from chipbench import flops, peaks, readers


def read(rec):
    return readers.roofline(rec, "ssd_chunks", "ssd_chunk", flops.ssd_chunks_launch,
                            peaks.TF32_OPS_PER_S)
