"""prep_ms.geomatch (ms): device ms of the `request.prep` span a request: the grid pyramid and every radius search, in the profiled stretch."""

from portbench import span_readers

NAME = "prep_ms.geomatch"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "request.prep", "device_ms", per_request=True)
