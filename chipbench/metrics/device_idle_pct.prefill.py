"""Share of the traced window in which no kernel, copy or set runs on the
device."""

from chipbench import readers


def read(rec):
    return readers.idle_pct(rec)
