"""Output tokens delivered in the window over the window's seconds."""

from chipbench import readers


def read(rec):
    return readers.output_tok_s(rec)
