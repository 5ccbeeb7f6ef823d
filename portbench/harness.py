"""One run of one cell: set-up, the measured window, the traced stretch,
the reference's check in its own process, and the result line.

Everything a cell is made of is found by name: the cell's file
(`workloads/<cell>.json`: its limits), its configuration
(`configs/<config>.json`, whose "model" names the module in `models/`
that makes the weights, the reference and the program's config), its
traffic (`traffic/<traffic>.json`, whose "driver" names the generator in
`drivers/`), and each metric (`metrics/<name>.py`, which `BENCHMARK.json`
lists for the cell).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "roitr_tpu")


def loaded_forbidden(extra=()) -> List[str]:
    """Top-level names of loaded modules (the part before the first dot,
    compared whole) that a run may not hold."""
    names = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(n for n in names if n in FORBIDDEN + tuple(extra))


def process_age_s() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: with trace, the per-layer metrics that
    list it (or, without a list, move one of its end-to-end metrics);
    without, its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def make_context(bench: dict, cell: str, seed: int, device, overrides: Optional[dict] = None):
    """Everything both sides share: the cell's files, its model's module,
    the reference's configuration (the program's comes from the same
    values) and the seed."""
    from portbench import models

    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    spec = load_json("workloads", f"{cell}.json")
    config = load_json("configs", f"{entry['config']}.json")
    model_name = config.get("model", models.DEFAULT)
    model = models.load(model_name, f"portbench/configs/{entry['config']}.json")
    values = dict(config["config"])
    traffic = dict(load_json("traffic", f"{entry['traffic']}.json"))
    overrides = overrides or {}
    values.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return types.SimpleNamespace(cell=cell, entry=entry, spec=spec, values=values,
                                 traffic=traffic, seed=int(seed), device=device,
                                 model_name=model_name, model=model,
                                 ref_cfg=model.reference_config(values), port_cfg=None,
                                 state_dict=None)


def driver_module(ctx):
    return importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")


# ------------------------------------------------------------------ window

@dataclasses.dataclass
class Run:
    ctx: types.SimpleNamespace
    train: bool
    bucket: int
    setup_s: float
    records: List[tuple]  # (start, end, pairs, profiled, ((src, tgt) valid points a pair))
    window_s: float
    attempted: int
    failed: int
    trace: Optional[dict] = None
    laps: Optional[dict] = None
    memory_peak_bytes: int = 0


def measure(ctx, driver, seconds: float, trace: bool, t_start_age: float, log=print) -> Run:
    """Set-up is done; run the window for `seconds` (the request or step
    under way at the deadline completes and counts) and, when traced, a
    profiled stretch and a lapped stretch from a third of it on.

    The driver's `step` returns the pairs it completed and appends each
    pair's (source, target) valid point counts to `driver.ran`; a driver
    with `agree(stop, stretch)` (one process of several) returns the
    decisions that all its processes take together."""
    from portbench import trace as tracing

    import torch

    setup_s = process_age_s() - t_start_age
    records, laps, summary = [], None, None
    agree = getattr(driver, "agree", lambda stop, stretch: (stop, stretch))
    cuda = str(ctx.device) != "cpu" and torch.cuda.is_available()
    t0 = time.perf_counter()
    attempted = 0
    stretch_done = not trace
    n = ctx.traffic["trace_steps"]

    def timed(fn, profiled: bool) -> None:
        i0 = len(driver.ran)
        a = time.perf_counter()
        pairs = fn()
        records.append((a, time.perf_counter(), pairs, profiled, tuple(driver.ran[i0:])))

    def lapped() -> int:
        pairs = sum(driver.step(timings=laps) for _ in range(n))
        if cuda:
            torch.cuda.synchronize()
        return pairs

    while True:
        now = time.perf_counter() - t0
        stop, stretch = agree(now >= seconds,
                              not stretch_done and now >= seconds / 3 and driver.boundary())
        if stretch:
            launches0 = tracing.launch_counts()
            i0, done = len(driver.ran), []
            s0 = time.perf_counter()
            summary = tracing.profile(lambda: done.extend(driver.step() for _ in range(n)),
                                      ctx.device)
            records.append((s0, time.perf_counter(), sum(done), True, tuple(driver.ran[i0:])))
            summary.update(launches=tracing.launch_delta(launches0), steps=n,
                           counts=list(driver.ran[i0:]))
            attempted += n
            while not driver.boundary():
                timed(driver.step, True)
                attempted += 1
            laps = {}
            timed(lapped, True)
            attempted += n
            laps = {k: v / n for k, v in laps.items()}
            stretch_done = True
            continue
        if stop and stretch_done:
            break
        timed(driver.step, False)
        attempted += 1
    window_s = records[-1][1] - t0
    log(f"[window] {window_s:.3f} s, {attempted} steps or requests, "
        f"{sum(r[2] for r in records)} pairs")
    log("[window] ms each: " + " ".join(f"{(r[1] - r[0]) * 1e3:.1f}" for r in records if not r[3]))
    return Run(ctx=ctx, train=driver.train, bucket=driver.bucket(), setup_s=setup_s,
               records=records, window_s=window_s, attempted=attempted,
               failed=getattr(driver, "failed", 0), trace=summary, laps=laps)


# --------------------------------------------------------------- reference

def reference_job(ctx, payload: dict) -> dict:
    """What the reference's process is sent: the run's cell, seed, device,
    model (by name: it lives outside the values), values, traffic and the
    program's outputs."""
    return {"cell": ctx.cell, "seed": ctx.seed, "device": str(ctx.device),
            "model": ctx.model_name, "values": ctx.values, "traffic": ctx.traffic,
            "payload": payload}


def reference_numbers(ctx, payload: dict) -> Dict[str, float]:
    """The comparison, computed in a fresh process that holds the reference
    and never the program (portbench/refproc.py); the job goes over a
    pipe."""
    import multiprocessing as mp

    spawn = mp.get_context("spawn")
    parent, child = spawn.Pipe()
    proc = spawn.Process(target=_refproc_entry, args=(child,))
    proc.start()
    child.close()
    try:
        parent.send(reference_job(ctx, payload))
        reply = parent.recv()
    finally:
        proc.join(timeout=120)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if "error" in reply:
        raise RuntimeError(f"reference process failed:\n{reply['error']}")
    return reply["numbers"]


def _refproc_entry(conn) -> None:
    from portbench import refproc

    refproc.serve(conn)


# ------------------------------------------------------------------ report

def metric_values(bench: dict, run: Run, trace: bool, log=print) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(bench, run.ctx.cell, trace):
        value = load_metric(m["name"]).read(run)
        if value is None:
            log(f"[metric] {m['name']}: nothing to read, left out")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    limit = "not read"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        if res.returncode == 0 and res.stdout.strip():
            limit = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return {"kind": name, "count": torch.cuda.device_count(), "power_limit": limit}


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start_age: float = 0.0, overrides: Optional[dict] = None,
             log=print) -> dict:
    """One run; returns the result dict (without printing it)."""
    import torch

    from portbench import models

    ctx = make_context(bench, cell, seed, device, overrides)
    ctx.port_cfg = ctx.model.program_config(ctx.values)
    module = driver_module(ctx)
    if hasattr(module, "run"):  # a driver of its own processes, one a chip
        run, payload = module.run(ctx, seconds, trace, t_start_age, bench, overrides, log)
    else:
        torch.manual_seed(seed)
        phases = [("imports and card", process_age_s())]
        ctx.state_dict = models.weights(ctx)
        phases.append(("weights", process_age_s()))
        driver = module.Driver(ctx)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        driver.setup()
        phases.append(("inputs, program and warm-up", process_age_s()))
        log("[setup] process age at the end of: " + ", ".join(
            f"{name} {age - t_start_age:.2f} s" for name, age in phases))
        run = measure(ctx, driver, seconds, trace, t_start_age, log)
        if device != "cpu":
            torch.cuda.synchronize()
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        payload = driver.payload()
        driver.close()
        ctx.state_dict = None
        del driver
        if device != "cpu":
            torch.cuda.empty_cache()
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules of {found} are loaded after the window")
    numbers = reference_numbers(ctx, payload)
    limits = ctx.spec["limits"]
    from portbench.judge import verdict

    correct = verdict(numbers, limits)
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metric_values(bench, run, trace, log),
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                         "count": int(ctx.entry["chips"]),
                         "memory_peak_bytes": run.memory_peak_bytes}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["compared"] = {k: {"value": numbers.get(k, float("nan")), "limit": v}
                          for k, v in limits.items()}
    result["_run"] = run
    return result


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start_age: float = 0.0) -> int:
    args = parse(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start_age, log=log)
    run = result.pop("_run")
    info = device_info()  # after the run: nvidia-smi is no part of set-up
    log(f"[device] {info['kind']} x{info['count']} (the cell uses {entry['chips']}), "
        f"power.limit {info['power_limit']}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = loaded_forbidden()
    if found:
        log(f"refused: modules of {found} are loaded in the process that prints the result")
        return 4
    log(f"[setup] {run.setup_s:.3f} s; [memory] peak {run.memory_peak_bytes} bytes")
    for k, v in result["compared"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
