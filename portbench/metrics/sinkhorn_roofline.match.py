"""sinkhorn_roofline.match (%): the sinkhorn kernel's bound over its mean device time a launch, serving."""

from portbench import readers  # noqa: F401

NAME = "sinkhorn_roofline.match"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "sinkhorn")
