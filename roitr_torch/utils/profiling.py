"""Profiling helpers: a torch.profiler trace, the program's named spans and
what they say about a trace.

Counterpart of roitr_tpu/utils/profiling.py. `trace()` records the
enclosed block with torch.profiler (the host's operators, and the card's
kernels when there is a card) into a Chrome trace that TensorBoard's
profiler plugin, chrome://tracing or Perfetto open; `log_elapsed` prints a
block's wall time as the JAX package's does.

`span(name)` names a region of the program. With no torch.profiler session
active it costs one flag check and records nothing. Under a session (the
`trace()` above, or any `torch.profiler.profile`) it opens a
`record_function`, so the span is a `user_annotation` event of the same
Chrome trace as the kernels, on their clock, and it appends an in-memory
record (name, parent record, root id, host start and end, and on a CUDA
path a timing event pair on the current stream); `span_summary()` reduces
the records per name. The spans of the port (PERF.md §3):

    request, request.h2d, request.normals, request.forward, request.d2h
        serving.py `Matcher.match` and `match_batch`
    model.local, model.transformer, model.matching (with model.ot inside)
        models/backbone.py, models/roitr.py: they tile request.forward
    knn, fps
        ops/neighbors.py `masked_knn` and `masked_min_dist`, ops/fps.py
    train.forward, train.backward, train.allreduce, train.optimizer
        parallel/train_step.py `train_step`
    loader.wait
        data/loader.py `iterate_batches`: the caller's wait on its queue

A span given a `laps` dict also synchronises the card at its edges and adds
its wall ms to `laps[<last part of the name>_ms]`, profiler or not: the
`timings` of `train_step`.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# records kept; older ones fall out of the ring
RING = 100_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
OUTSIDE = "(no span)"

_profiler_enabled = torch.autograd._profiler_enabled
_records: "collections.deque[SpanRecord]" = collections.deque(maxlen=RING)
_roots = itertools.count()
_local = threading.local()


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Record the enclosed block into log_dir/<host>.<pid>.<ms>.pt.trace.json
    (torch.profiler's TensorBoard layout), with CUDA activity when a card
    is present. Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def trace_events(log_dir: str) -> List[dict]:
    """The events of the newest Chrome trace that `trace()` wrote to log_dir."""
    path = max(glob.glob(os.path.join(log_dir, "*.pt.trace.json")), key=os.path.getmtime)
    with open(path) as f:
        return json.load(f)["traceEvents"]


class SpanRecord:
    """One span's record: `root` numbers the outermost span it ran under (a
    request or a step), `t0_ns` / `t1_ns` are perf_counter_ns on the host
    (`t1_ns` None while open), `events` the CUDA start and end events or
    None."""

    __slots__ = ("name", "parent", "root", "t0_ns", "t1_ns", "events")

    def __init__(self, name: str, parent: Optional["SpanRecord"], root: int):
        self.name, self.parent, self.root = name, parent, root
        self.t0_ns = self.t1_ns = self.events = None


def _stack() -> List[SpanRecord]:
    """This thread's open records, outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda(device) -> Optional[torch.device]:
    """The CUDA device a span's work runs on, or None (see `span`)."""
    if device is False:
        return None
    if device is True:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_initialized() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


class _Span:
    __slots__ = ("name", "device", "laps", "fn", "rec", "lap_t0")

    def __init__(self, name: str, device, laps: Optional[dict]):
        self.name, self.device, self.laps = name, _cuda(device), laps
        self.fn = self.rec = None

    def __enter__(self):
        if self.laps is not None:
            if self.device is not None:
                torch.cuda.synchronize(self.device)
            self.lap_t0 = time.perf_counter()
        if not _profiler_enabled():
            return self
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        stack = _stack()
        # a span inside one of its own name counts once, as the outer one
        if any(r.name == self.name for r in stack):
            return self
        rec = SpanRecord(self.name, stack[-1] if stack else None,
                         stack[0].root if stack else next(_roots))
        if self.device is not None and not torch.cuda.is_current_stream_capturing():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(torch.cuda.current_stream(self.device))
        rec.t0_ns = time.perf_counter_ns()
        stack.append(rec)
        _records.append(rec)
        self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record(torch.cuda.current_stream(self.device))
            rec.t1_ns = time.perf_counter_ns()
            _stack().pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.laps is not None:
            if self.device is not None:
                torch.cuda.synchronize(self.device)
            key = self.name.rsplit(".", 1)[-1] + "_ms"
            self.laps[key] = self.laps.get(key, 0.0) + (time.perf_counter() - self.lap_t0) * 1e3
        return False


# the span when nothing is recorded
_OFF = contextlib.nullcontext()


def span(name: str, device=True, laps: Optional[dict] = None):
    """A named region of the program (see the module's docstring).

    `device`: where the region's work runs, a torch.device (or a string
    torch.device takes) or True for the current CUDA device when CUDA is
    initialised; on a CUDA device the span also times its stream with an
    event pair (none while the stream is being captured into a graph).
    False: host work only. It adds no synchronisation unless given `laps`."""
    if laps is None and not _profiler_enabled():
        return _OFF
    return _Span(name, device, laps)


def reset_spans() -> None:
    """Forget every record."""
    _records.clear()


def span_records() -> List[SpanRecord]:
    """The records, oldest first (at most RING of them)."""
    return list(_records)


def span_summary() -> Dict[str, dict]:
    """Per span name, over its closed records: calls; host_ms (end minus
    start); self_host_ms (host_ms minus that of its child spans); device_ms
    (from its start event to its end event on the stream, idle included,
    summed over calls), None where no record has events (a CPU path).
    Synchronises the card once when there are events to read."""
    recs = [r for r in _records if r.t1_ns is not None]
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    child_ns: Dict[SpanRecord, int] = collections.defaultdict(int)
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] += r.t1_ns - r.t0_ns
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                    "device_ms": None})
        s["calls"] += 1
        s["host_ms"] += (r.t1_ns - r.t0_ns) * 1e-6
        s["self_host_ms"] += (r.t1_ns - r.t0_ns - child_ns.get(r, 0)) * 1e-6
        if r.events is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
    return out


def device_idle_by_span(events: List[dict], names=None) -> Dict[str, float]:
    """Device idle ms of a Chrome trace, by the innermost program span open
    on the host over each gap. The stretch runs from the first host event to
    the last event's end (host operators and annotations, runtime calls,
    device work); busy is the union of the device's kernels, copies
    and memsets; each gap in it goes to the latest-started span (a
    `user_annotation` whose name is in `names`, by default those recorded)
    open at the gap's midpoint, or to OUTSIDE."""
    names = {r.name for r in _records} if names is None else set(names)
    xs = [e for e in events if e.get("ph") == "X"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in xs if e.get("cat") in DEVICE_CATS)
    host = [e for e in xs if e.get("cat") in HOST_CATS]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                   for e in host if e.get("cat") == "user_annotation" and e["name"] in names)
    if not host:
        return {}
    start = min(float(e["ts"]) for e in host)
    end = max([float(e["ts"]) + float(e.get("dur", 0)) for e in host] + [b for _, b in dev])
    gaps, cursor = [], start
    for a, b in dev:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if end > cursor:
        gaps.append((cursor, end))
    starts = np.array([a for a, _, _ in spans])
    idle: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [s for s in spans[:int(np.searchsorted(starts, mid, side="right"))]
                 if s[1] >= mid]
        idle[open_[-1][2] if open_ else OUTSIDE] += (b - a) * 1e-3
    return dict(idle)


def span_table(summary: Dict[str, dict], idle: Optional[Dict[str, float]] = None) -> List[str]:
    """Lines of a table of `span_summary()`, with each span's device idle
    from `device_idle_by_span` where given."""
    idle = idle or {}
    fmt = lambda v: f"{'n/a':>9s}" if v is None else f"{v:9.2f}"  # noqa: E731
    lines = [f"{'span':18s} {'calls':>6s} {'host ms':>9s} {'self ms':>9s} {'device ms':>9s} "
             f"{'idle ms':>9s}"]
    for name, s in sorted(summary.items()):
        lines.append(f"{name:18s} {s['calls']:6d} {fmt(s['host_ms'])} "
                     f"{fmt(s['self_host_ms'])} {fmt(s['device_ms'])} {fmt(idle.get(name))}")
    if OUTSIDE in idle:
        lines.append(f"{OUTSIDE:18s} {'':6s} {'':9s} {'':9s} {'':9s} {fmt(idle[OUTSIDE])}")
    return lines


@contextlib.contextmanager
def log_elapsed(label: str, printer=print):
    t0 = time.perf_counter()
    yield
    printer(f"{label}: {(time.perf_counter() - t0) * 1e3:.1f}ms")
