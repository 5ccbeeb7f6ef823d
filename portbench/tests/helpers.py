"""Shared set-up of the benchmark's CPU tests: the cells at a small
bucket (1024) with few, small pairs."""

from __future__ import annotations

import json

from portbench.harness import ROOT

TINY = {"config": {"buckets": [1024]},
        "traffic": {"points": [600, 1000], "pool": 4, "check": 2, "warmup": 1}}
SEED = 2200000123


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def context(cell: str, seed: int = SEED):
    from portbench import harness

    ctx = harness.make_context(bench(), cell, seed, "cpu", TINY)
    ctx.port_cfg = ctx.model.program_config(ctx.values)
    return ctx
