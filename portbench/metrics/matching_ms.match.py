"""matching_ms.match (ms): device ms of the `model.matching` span (projections, partition, coarse matching, patches, OT, fine matching) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "matching_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "model.matching", "device_ms", per_request=True)
