"""kpconv_ms.geomatch (ms): device ms of the `kpconv` spans (the 11 KPConvs) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "kpconv_ms.geomatch"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "kpconv", "device_ms", per_request=True)
