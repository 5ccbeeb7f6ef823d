"""Training orchestration: epoch loop, running-average scalars, checkpoints.

Counterpart of roitr_tpu/train/trainer.py (reference lib/trainer.py:9-344):
train steps over a shuffled epoch, a validation pass, one checkpoint per
epoch and one per best metric under snapshot/<exp_dir>/checkpoints, and
resume from cfg.pretrain. One pair a step on one card (or on the CPU when
asked, with the kernels' plain versions).

    trainer = Trainer(cfg)                  # device="cuda"; datasets from cfg
    best = trainer.train()

A dataset is a sequence of preprocessed items (numpy dicts of one padded
pair with its GT transform, as data/tdmatch.py `TDMatchDataset` and
data/synthetic.py `SyntheticPairs` yield); without one, the split of the
config is read (data/__init__.py `get_dataset`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.loader import iterate_batches
from roitr_torch.models.roitr import RoITr, resolve_device
from roitr_torch.parallel.train_step import eval_step, make_optimizer, train_step
from roitr_torch.train.checkpoint import (
    init_best_metrics,
    load_checkpoint,
    save_checkpoint,
    update_bests,
)
from roitr_torch.utils.logging import Logger, MetricMeters, ScalarWriter, Timer


class Trainer:
    """With `time_steps`, `step_times` holds the current epoch's per-step
    forward, backward and optimizer ms; that synchronises the card at each
    border, so it is off by default."""

    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None, device="cuda",
                 time_steps: bool = False):
        if cfg.batch_size != 1 or cfg.packed_batch:
            raise NotImplementedError("one pair a step: batches and packed batches are a later "
                                      "slice of the port")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_dataset = (get_dataset(cfg, "train") if train_dataset is None
                              else train_dataset)
        self.val_dataset = get_dataset(cfg, "val") if val_dataset is None else val_dataset
        self.snapshot_dir = os.path.join("snapshot", cfg.exp_dir)
        self.ckpt_dir = os.path.join(self.snapshot_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger = Logger(self.snapshot_dir)
        self.writer = ScalarWriter(self.snapshot_dir)

        self.model = RoITr(cfg, device=self.device, seed=cfg.seed)
        steps_per_epoch = min(len(self.train_dataset), cfg.training_max_iter)
        self.optimizer = make_optimizer(cfg, self.model, steps_per_epoch)
        self.step = 0
        self.start_epoch = 0
        self.best_metrics = init_best_metrics()
        self.time_steps = time_steps
        self.step_times: List[Dict[str, float]] = []
        if cfg.pretrain:
            self._resume(cfg.pretrain)

    def _resume(self, path: str) -> None:
        ckpt = load_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(ckpt["model"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.step = ckpt["step"]
        self.start_epoch = ckpt["epoch"] + 1
        self.best_metrics.update(ckpt["best_metrics"])
        self.logger.write(f"resumed from {path} at epoch {self.start_epoch}\n")

    def _save(self, name: str, epoch: int) -> None:
        save_checkpoint(os.path.join(self.ckpt_dir, f"{name}.pth"), self.model, self.optimizer,
                        self.step, epoch, self.best_metrics)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        meters = MetricMeters()
        timer = Timer()
        generator = torch.Generator().manual_seed(cfg.seed + epoch)
        self.model.train()
        pairs = iterate_batches(self.train_dataset, shuffle=True, seed=cfg.seed + epoch,
                                max_items=cfg.training_max_iter, device=self.device)
        self.step_times = []
        for it, pair in enumerate(pairs):
            timer.tic()
            timings = {} if self.time_steps else None
            metrics = train_step(self.model, self.optimizer, pair, generator, timings)
            self.step += 1
            timer.toc()
            if timings is not None:
                self.step_times.append(timings)
            meters.update(metrics)
            if cfg.verbose and (it + 1) % cfg.verbose_freq == 0:
                self.logger.write(f"epoch {epoch} iter {it + 1}: {meters.summary()}, "
                                  f"{timer.avg:.3f}s/it\n")
                # running averages, as the reference's scalar stream records
                self.writer.write("train", self.step, meters.averages())
        return meters.averages()

    def eval_epoch(self, epoch: int) -> Dict[str, float]:
        meters = MetricMeters()
        self.model.eval()
        for pair in iterate_batches(self.val_dataset, max_items=self.cfg.val_max_iter,
                                    device=self.device):
            meters.update(eval_step(self.model, pair))
        avgs = meters.averages()
        self.logger.write(f"epoch {epoch} val: {meters.summary()}\n")
        self.writer.write("val", self.step, avgs)
        return avgs

    def train(self) -> Dict[str, float]:
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            self.logger.write(f"epoch {epoch} train done in {time.time() - t0:.0f}s: "
                              + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(train_metrics.items()))
                              + "\n")
            improved = update_bests(self.best_metrics, self.eval_epoch(epoch))
            self._save(f"model_{epoch}", epoch)
            for name, better in improved.items():
                if better:
                    self._save(f"model_best_{name}", epoch)
        return self.best_metrics

    def eval(self) -> Dict[str, float]:
        return self.eval_epoch(self.start_epoch)
