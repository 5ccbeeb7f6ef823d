"""What the per-layer metrics of the program's spans read.

The program names its regions with `roitr_torch.utils.profiling.span`,
which records only while a torch.profiler session is active: in a traced
run, the profiled stretch (portbench/trace.py `profile`). The harness's
process then holds exactly that stretch's records, and
`span_summary()` reduces them per span name after the window, as
`trace.launch_counts` reads the program's launch counter. A checkout whose
program has no spans reads nothing.
"""

from __future__ import annotations

from typing import Optional


def span_ms(run, name: str, field: str, per_request: bool = False) -> Optional[float]:
    """The span `name`'s `field` ("device_ms" or "host_ms", summed over
    its calls) in the profiled stretch, over the stretch's pairs. Nothing
    on the CPU, without a trace, when the program records no such span, or,
    with `per_request`, unless the stretch holds one `request` span a
    request."""
    t = run.trace
    if t is None or str(run.ctx.device) == "cpu" or not t.get("counts"):
        return None
    try:
        from roitr_torch.utils.profiling import span_summary
    except ImportError:
        return None
    summary = span_summary()
    pairs = len(t["counts"])
    if per_request and summary.get("request", {}).get("calls") != pairs:
        return None
    value = summary.get(name, {}).get(field)
    return None if value is None else value / pairs
