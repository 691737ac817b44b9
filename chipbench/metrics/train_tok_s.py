"""Training positions of the steps finished in the window over its seconds."""

from chipbench import readers


def read(rec):
    return readers.train_tok_s(rec)
