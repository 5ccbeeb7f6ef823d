"""mfu.match (%): required products of a request times requests over wall time over the dense peak."""

from portbench import readers  # noqa: F401

NAME = "mfu.match"
UNIT = "%"


def read(run):
    return readers.mfu_pct(run)
