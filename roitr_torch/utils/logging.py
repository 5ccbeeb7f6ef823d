"""Metrics meters, run logger, and wall-clock timer.

A copy of roitr_tpu/utils/logging.py (reference lib/utils.py:621-688:
AverageMeter, Logger, Timer), with its JSONL scalar writer in place of
tensorboardX (reference trainer.py:42,277-280).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.sq_sum = 0.0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.sq_sum += float(val) ** 2 * n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        var = self.sq_sum / self.count - self.avg**2
        return max(var, 0.0) ** 0.5


class MetricMeters:
    """Dict of AverageMeters keyed by metric name."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            self.meters[k].update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def summary(self) -> str:
        return ", ".join(f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items()))

    def reset(self):
        self.meters.clear()


class Logger:
    """Plain-file logger (reference lib/utils.py:674-688) writing
    snapshot/<exp>/log, plus stdout."""

    def __init__(self, path: str, also_stdout: bool = True):
        os.makedirs(path, exist_ok=True)
        self.fw = open(os.path.join(path, "log"), "a")
        self.also_stdout = also_stdout

    def write(self, text: str):
        self.fw.write(text)
        self.fw.flush()
        if self.also_stdout:
            print(text, end="", flush=True)

    def close(self):
        self.fw.close()


class ScalarWriter:
    """JSONL scalar event stream: one {"step", "phase", <metrics>} per line."""

    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.fw = open(os.path.join(path, "events.jsonl"), "a")

    def write(self, phase: str, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step), "phase": phase, "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.fw.write(json.dumps(rec) + "\n")
        self.fw.flush()

    def close(self):
        self.fw.close()


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)
