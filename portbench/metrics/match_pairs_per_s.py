"""match_pairs_per_s (pairs/s): pairs whose Matcher.match returned in the window over its seconds."""

from portbench import readers  # noqa: F401

NAME = "match_pairs_per_s"
UNIT = "pairs/s"


def read(run):
    return readers.window_rate(run)
