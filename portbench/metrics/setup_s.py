"""setup_s (s): process start to the first timed request or step: interpreter, torch, the kernels' libraries, weights, inputs, warm-up."""

NAME = "setup_s"
UNIT = "s"


def read(run):
    return run.setup_s
