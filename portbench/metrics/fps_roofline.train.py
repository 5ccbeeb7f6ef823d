"""fps_roofline.train (%): the fps kernel's bound over its mean device time a launch, training."""

from portbench import readers  # noqa: F401

NAME = "fps_roofline.train"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "fps")
