"""Device time of the AdamW update (``adamw.update``), clipping included."""

from chipbench import readers


def read(rec):
    return readers.span_ms(rec, "adamw_update")
