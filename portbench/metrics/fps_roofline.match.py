"""fps_roofline.match (%): the fps kernel's bound over its mean device time a launch, serving."""

from portbench import readers  # noqa: F401

NAME = "fps_roofline.match"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "fps")
