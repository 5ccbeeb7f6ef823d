"""lgr_ms.geomatch (ms): device ms of the `model.lgr` span (local-to-global registration) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "lgr_ms.geomatch"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "model.lgr", "device_ms", per_request=True)
