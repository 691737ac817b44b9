"""The window's FLOPs (the benchmark's count) over the window times the
card's peak."""

from chipbench import readers


def read(rec):
    return readers.mfu(rec)
