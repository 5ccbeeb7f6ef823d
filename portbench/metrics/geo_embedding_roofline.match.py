"""geo_embedding_roofline.match (%): the geo_embedding kernel's bound over its mean device time a launch, serving."""

from portbench import readers  # noqa: F401

NAME = "geo_embedding_roofline.match"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "geo_embedding")
