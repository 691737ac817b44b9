"""The prefill FFN's least time over its kernels' time (range around
apply_ffn in extend calls)."""

from chipbench import readers


def read(rec):
    return readers.roofline(rec, "ffn.extend")
