"""rpe_attention_roofline.match (%): the rpe_attention kernel's bound over its mean device time a launch, serving."""

from portbench import readers  # noqa: F401

NAME = "rpe_attention_roofline.match"
UNIT = "%"


def read(run):
    return readers.kernel_roofline_pct(run, "rpe_attention")
