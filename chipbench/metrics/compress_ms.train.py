"""Device time of the int8 error-feedback compression of the gradients
(``compress.compressed_grad_tree``)."""

from chipbench import readers


def read(rec):
    return readers.span_ms(rec, "compressed_grad_tree")
