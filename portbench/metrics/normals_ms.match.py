"""normals_ms.match (ms): device ms of the `request.normals` spans (the device normals' kNN-33 and PCA) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "normals_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "request.normals", "device_ms", per_request=True)
