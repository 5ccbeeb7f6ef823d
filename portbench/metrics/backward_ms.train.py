"""backward_ms.train (ms): train_step's backward lap, mean a pair."""

from portbench import readers  # noqa: F401

NAME = "backward_ms.train"
UNIT = "ms"


def read(run):
    return readers.lap_ms(run, "backward_ms")
