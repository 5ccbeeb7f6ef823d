"""sinkhorn_roofline.train (%): the sinkhorn kernel's bound over its mean device time a launch, training."""

from portbench import readers  # noqa: F401

NAME = "sinkhorn_roofline.train"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "sinkhorn")
