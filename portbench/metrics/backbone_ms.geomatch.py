"""backbone_ms.geomatch (ms): device ms of the `model.backbone` span (the KPConv-FPN) a request, in the profiled stretch."""

from portbench import span_readers

NAME = "backbone_ms.geomatch"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "model.backbone", "device_ms", per_request=True)
