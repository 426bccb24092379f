"""The window's peak of allocated device memory
(``torch.cuda.max_memory_allocated``)."""

from chipbench import readers


def read(rec):
    return readers.peak_gib(rec)
