"""A profiled stretch and what the benchmark reads from its trace.

`profile` records a few requests or steps with torch.profiler (host
operators and the card's activity), writes the Chrome trace to a temporary
directory and reduces it (`reduce`) to:

- window_s: from the first host operator to the last event's end;
- busy_s: the length of the union of device intervals (kernels, copies,
  memsets), never their sum, so overlapping kernels count once;
- kernel_s: device seconds of each of the port's kernels, by the names of
  their CUDA functions (roofline.KERNEL_FUNCTIONS);
- device_ops: the ten device operations by name that took most time;
- idle_gaps: the gaps in the union, each attributed to the innermost host
  operator open at its midpoint or, where none is, to the host's time
  between operators before the next one it started; summed by that name,
  the ten largest.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List

import numpy as np

from portbench.roofline import KERNEL_FUNCTIONS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# how far back from a gap's midpoint to look for the host operator open there
LOOKBACK = 64
_NAME = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
    sorted({f for fs in KERNEL_FUNCTIONS.values() for f in fs}, key=len, reverse=True))
    + r")(?![A-Za-z0-9_])")
_OWNER = {f: k for k, fs in KERNEL_FUNCTIONS.items() for f in fs}


def launch_counts() -> Dict[str, int]:
    """The program's counter of kernel launches, by kernel."""
    from roitr_torch.kernels import launch_counts as counts

    return dict(counts)


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = launch_counts()
    return {k: now[k] - before.get(k, 0) for k in now}


def profile(fn, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if str(device) != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch_profile(activities=activities) as prof:
            fn()
            if str(device) != "cpu":
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce(events)


def kernel_of(name: str):
    """The port's kernel a CUDA function name belongs to, or None."""
    m = _NAME.search(name)
    return _OWNER[m.group(1)] if m else None


def union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce(events: List[dict]) -> dict:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    if not host:
        raise RuntimeError("the trace holds no host operators")
    start = min(float(e["ts"]) for e in host)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in host + dev)
    spans = union([(max(float(e["ts"]), start), min(float(e["ts"]) + float(e["dur"]), end))
                   for e in dev])
    busy = sum(b - a for a, b in spans)
    by_name: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"][:160]] += float(e["dur"]) * 1e-6
        k = kernel_of(e["name"])
        if k is not None:
            kernel_s[k] += float(e["dur"]) * 1e-6
    gaps, cursor = [], start
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if end > cursor:
        gaps.append((cursor, end))
    idle = attribute_gaps(gaps, host)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"window_s": (end - start) * 1e-6, "busy_s": busy * 1e-6,
            "kernel_s": dict(kernel_s), "device_ops": top(by_name), "idle_gaps": top(idle)}


def attribute_gaps(gaps: List[tuple], host: List[dict]) -> Dict[str, float]:
    """Seconds of device idle by what the host was doing (see `reduce`)."""
    host = sorted(host, key=lambda e: float(e["ts"]))
    ts = np.array([float(e["ts"]) for e in host])
    end = ts + np.array([float(e.get("dur", 0)) for e in host])
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        pos = int(np.searchsorted(ts, mid, side="right"))
        lo = max(0, pos - LOOKBACK)
        open_ = np.nonzero(end[lo:pos] >= mid)[0]
        if open_.size:
            name = host[lo + int(open_[-1])]["name"]
        else:
            nxt = int(np.searchsorted(ts, a, side="left"))
            name = "between operators, before " + (host[nxt]["name"] if nxt < len(host)
                                                   else "the end")
        idle[name[:160]] += (b - a) * 1e-6
    return idle
