"""enqueue_ms.match (ms): host ms of the `request.forward` span a request: how long the host takes to issue the forward, in the profiled stretch."""

from portbench import span_readers

NAME = "enqueue_ms.match"
UNIT = "ms"


def read(run):
    return span_readers.span_ms(run, "request.forward", "host_ms", per_request=True)
