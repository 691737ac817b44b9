"""90th percentile, over every request sent in the window, of the time
from its sending to the step that delivered its first token."""

from chipbench import readers


def read(rec):
    return readers.ttft_ms(rec, 90)
