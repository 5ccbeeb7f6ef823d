"""transformer_ms.match (ms): device ms of the `model.transformer` span (the global geometric transformer) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "transformer_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "model.transformer", "device_ms", per_request=True)
