"""knn_ms.train (ms): device ms of the `knn` spans (the forward's searches) a pair, in the profiled stretch."""

from portbench import span_readers

NAME = "knn_ms.train"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "knn", "device_ms")
