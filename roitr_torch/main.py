"""The port's command line, counterpart of the JAX package's main.py
(reference main.py:19-139):

    python -m roitr_torch <config.yaml> [--mode train|val|test] [--device cuda|cpu]

loads the two-level YAML config (`--mode` overrides its `mode`), seeds
numpy with `cfg.seed`, copies the package's sources into
snapshot/<exp_dir>/src (rank 0), and runs the Trainer (`train`, `val`) or
the Tester (`test`) of `eval/tester.py` `get_trainer` on the card, or on
the CPU with `--device cpu`. Data parallelism is torchrun's, one process a
card, with `dp_size` set to the number of processes:

    torchrun --nproc_per_node=4 -m roitr_torch configs/train/tdmatch.yaml

`pretrain` names a port checkpoint (snapshot/<exp_dir>/checkpoints/*.pth)
to resume from in training, or the weights to test, which may also be a
reference RoITr `.pth` (train/checkpoint.py `load_model_state`).
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

import numpy as np

from roitr_torch.config import load_config
from roitr_torch.eval.tester import get_trainer
from roitr_torch.models.roitr import resolve_device
from roitr_torch.parallel.distributed import init_distributed, is_main

PACKAGE = os.path.dirname(os.path.abspath(__file__))
# the runner's method for each mode
RUNS = {"train": "train", "val": "eval", "test": "test"}


def snapshot_sources(snapshot_dir: str) -> None:
    """Copy the package's sources into snapshot_dir/src for provenance
    (reference main.py:55-65)."""
    shutil.copytree(PACKAGE, os.path.join(snapshot_dir, "src", "roitr_torch"),
                    dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))


def main(argv: Optional[Sequence[str]] = None):
    """Parse argv (sys.argv's arguments when None), run the config's mode;
    returns the Trainer or the Tester that ran."""
    parser = argparse.ArgumentParser(prog="python -m roitr_torch")
    parser.add_argument("config", help="two-level YAML config (configs/{train,test}/*.yaml)")
    parser.add_argument("--mode", choices=tuple(RUNS), default=None,
                        help="override the config's mode")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the kernels; default) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, **({"mode": args.mode} if args.mode else {}))
    if cfg.mode not in RUNS:
        raise ValueError(f"mode must be one of {tuple(RUNS)}, got {cfg.mode!r}")
    np.random.seed(cfg.seed)
    # under torchrun this joins the process group, before anything is saved
    device = init_distributed(cfg, resolve_device(args.device))
    if is_main():
        snapshot_sources(os.path.join("snapshot", cfg.exp_dir))

    runner = get_trainer(cfg, device=device)
    getattr(runner, RUNS[cfg.mode])()
    return runner
