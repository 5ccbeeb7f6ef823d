"""forward_ms.train (ms): train_step's forward lap (losses included), mean a pair."""

from portbench import readers  # noqa: F401

NAME = "forward_ms.train"
UNIT = "ms"


def read(run):
    return readers.lap_ms(run, "forward_ms")
