"""knn_ms.match (ms): device ms of the `knn` spans (normals and backbone searches) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "knn_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "knn", "device_ms", per_request=True)
