"""device_idle.match (%): share of the profiled stretch with no device activity (union of intervals)."""

from portbench import readers  # noqa: F401

NAME = "device_idle.match"
UNIT = "%"


def read(run):
    return readers.device_idle_pct(run)
