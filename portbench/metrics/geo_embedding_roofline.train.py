"""geo_embedding_roofline.train (%): the geo_embedding kernel's bound over its mean device time a launch, training."""

from portbench import readers  # noqa: F401

NAME = "geo_embedding_roofline.train"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "geo_embedding")
