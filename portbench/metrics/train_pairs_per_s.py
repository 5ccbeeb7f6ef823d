"""train_pairs_per_s (pairs/s): pairs through train_step in the window over its seconds."""

from portbench import readers  # noqa: F401

NAME = "train_pairs_per_s"
UNIT = "pairs/s"


def read(run):
    return readers.window_rate(run)
