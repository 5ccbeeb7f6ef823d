"""Checkpoints with the reference's tracked-best semantics.

Counterpart of roitr_tpu/train/checkpoint.py (reference
lib/trainer.py:65-130, 309-330): one file per epoch and one per best
metric. The port's format is its own, one `torch.save` file holding the
model's state_dict, the optimizer's state (moments, schedule position,
`iter_size` accumulation), the step, the epoch and the best metrics; it
does not read the JAX package's orbax directories.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import torch

BEST_METRICS = ("loss", "c_loss", "f_loss", "o_loss", "PIR", "IR")
# metrics where larger is better (reference trainer.py:317-330)
MAXIMIZE = ("PIR", "IR")


def save_checkpoint(path: str, model: torch.nn.Module, optimizer, step: int, epoch: int,
                    best_metrics: Dict[str, float]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "step": int(step), "epoch": int(epoch),
                "best_metrics": {k: float(v) for k, v in best_metrics.items()}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=False)


def init_best_metrics() -> Dict[str, float]:
    return {k: (-math.inf if k in MAXIMIZE else math.inf) for k in BEST_METRICS}


def update_bests(best: Dict[str, float], current: Dict[str, float]) -> Dict[str, bool]:
    """Returns {metric: improved?} and updates `best` in place."""
    improved = {}
    for k in BEST_METRICS:
        if k not in current:
            improved[k] = False
            continue
        cur = float(current[k])
        improved[k] = cur > best[k] if k in MAXIMIZE else cur < best[k]
        if improved[k]:
            best[k] = cur
    return improved
