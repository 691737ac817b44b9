"""The train step's forward FFN least time (TF32 rate) over its kernels'
time."""

from chipbench import readers


def read(rec):
    return readers.roofline(rec, "ffn.train")
