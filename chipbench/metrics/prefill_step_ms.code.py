"""Mean host time of the window's engine steps that carried a prefill chunk."""

from chipbench import readers


def read(rec):
    return readers.prefill_step_ms(rec)
