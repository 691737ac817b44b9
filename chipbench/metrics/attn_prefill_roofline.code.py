"""The prefill attention block's least time over its kernels' time (range
around apply_attention_extend)."""

from chipbench import readers


def read(rec):
    return readers.roofline(rec, "attn_extend")
