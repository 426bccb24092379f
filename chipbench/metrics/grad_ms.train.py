"""Device time of the step's loss and gradients (``steps.loss_and_grads``):
forward, per-layer recomputation and backward."""

from chipbench import readers


def read(rec):
    return readers.span_ms(rec, "loss_and_grads")
