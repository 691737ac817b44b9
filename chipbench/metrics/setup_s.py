"""Set-up: process start to the window's opening (host clock)."""

from chipbench import readers


def read(rec):
    return readers.setup_s(rec)
