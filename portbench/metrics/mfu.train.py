"""mfu.train (%): required products of a step times steps over wall time over the dense peak."""

from portbench import readers  # noqa: F401

NAME = "mfu.train"
UNIT = "%"


def read(run):
    return readers.mfu_pct(run)
