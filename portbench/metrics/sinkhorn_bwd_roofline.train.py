"""sinkhorn_bwd_roofline.train (%): the sinkhorn_bwd kernel's bound over its mean device time a launch, training."""

from portbench import readers  # noqa: F401

NAME = "sinkhorn_bwd_roofline.train"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "sinkhorn_bwd")
