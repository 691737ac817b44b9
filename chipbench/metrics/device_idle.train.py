"""The share of the profiled window in which no device operation ran."""

from chipbench import readers


def read(rec):
    return readers.device_idle(rec)
