"""match_ms.p90 (ms): 90th percentile of every request's wall time in the window."""

from portbench import readers  # noqa: F401

NAME = "match_ms.p90"
UNIT = "ms"


def read(run):
    return readers.request_p90_ms(run)
