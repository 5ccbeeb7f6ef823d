"""local_ms.match (ms): device ms of the `model.local` spans (FPS pyramids, neighbourhoods, local PPF attention, upsampling) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "local_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "model.local", "device_ms", per_request=True)
