"""device_idle.train (%): share of the profiled stretch with no device activity (union of intervals)."""

from portbench import readers  # noqa: F401

NAME = "device_idle.train"
UNIT = "%"


def read(run):
    return readers.device_idle_pct(run)
