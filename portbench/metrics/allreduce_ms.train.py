"""allreduce_ms.train (ms): train_step's lap of the flat buffer's all-reduce, mean a step."""

from portbench import readers

NAME = "allreduce_ms.train"
UNIT = "ms"


def read(run):
    return readers.lap_ms(run, "allreduce_ms")
