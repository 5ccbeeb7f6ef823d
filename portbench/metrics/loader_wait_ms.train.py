"""loader_wait_ms.train (ms): host ms of the `loader.wait` spans a pair: the step's wait on the loader's prefetch queue, in the profiled stretch."""

from portbench import span_readers

NAME = "loader_wait_ms.train"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "loader.wait", "host_ms")
