"""What each metric file reads from a run (portbench/harness.py `Run`):
the window's records, the profiled stretch's trace summary, the laps of
`train_step` and the program's launch counter. A reader that finds nothing
to read returns None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from portbench import flops, roofline, stats


def window_rate(run) -> float:
    """Pairs completed in the window over its seconds."""
    return stats.rate(sum(r[2] for r in run.records), run.window_s)


def request_p90_ms(run) -> float:
    return stats.p90([(r[1] - r[0]) * 1e3 for r in run.records if not r[3]])


def device_idle_pct(run) -> Optional[float]:
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(run) -> Optional[float]:
    """Products the equations require for the pairs done outside the
    profiled and lapped stretches (each at its own valid point counts),
    over their wall time, over the dense tensor-core peak of the chips the
    cell uses."""
    plain = [r for r in run.records if not r[3]]
    if not plain:
        return None
    per = flops.train_step_flops if run.train else flops.request_flops
    work = sum(per(run.ctx.ref_cfg, counts) for r in plain for counts in r[4])
    secs = sum(r[1] - r[0] for r in plain)
    chips = run.ctx.entry["chips"]
    return 100.0 * work / secs / (chips * roofline.TENSOR_FLOP_PER_S)


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    """The launches' bound, at the valid sizes of the pairs the profiled
    stretch ran, over the kernel's device time there; nothing when it did
    not run there or ran a different number of launches than those pairs
    give (the shapes are then unknown)."""
    t = run.trace
    if t is None or not t["kernel_s"].get(kernel) or not t["launches"].get(kernel):
        return None
    shapes = [launch for counts in t["counts"]
              for launch in roofline.launches(run.ctx.ref_cfg, counts, run.train).get(kernel, [])]
    if t["launches"][kernel] != len(shapes):
        return None
    bound = sum(roofline.bound_s(kernel, *parts) for parts in shapes)
    return 100.0 * bound / t["kernel_s"][kernel]


def lap_ms(run, name: str) -> Optional[float]:
    if not run.laps or name not in run.laps:
        return None
    return run.laps[name]
