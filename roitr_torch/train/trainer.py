"""Training orchestration: epoch loop, running-average scalars, checkpoints.

Counterpart of roitr_tpu/train/trainer.py (reference lib/trainer.py:9-344):
train steps over a shuffled epoch, a validation pass, one checkpoint per
epoch and one per best metric under snapshot/<exp_dir>/checkpoints, and
resume from cfg.pretrain. A step takes `cfg.batch_size` same-bucket pairs
(a list of single pairs, or with `cfg.packed_batch` one packed pair, which
needs host pyramids) on one card, or on the CPU when asked, with the
kernels' plain versions. Pairs are prepared in min(cfg.num_workers, cores)
worker subprocesses (data/worker_pool.py; 0: in the loader's thread).

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
from roitr_torch.parallel.train_step import batch_pairs, eval_step, make_optimizer, train_step
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
    border, so it is off by default.

    The learning rate falls once an epoch. At batch_size 1 an epoch is
    min(len(train set), training_max_iter) batches, and the staircase
    counts updates as JAX's does (optax.exponential_decay with
    transition_steps = pairs // iter_size). At batch_size B > 1 an epoch's
    number of batches depends on how its pairs fall into buckets (each
    bucket's ragged tail is a batch of its own), so the rate falls at each
    epoch's end (the reference's ExpLR); JAX's trainer gives its optimizer
    the epoch's pairs there, so its rate falls once in B epochs.
    training_max_iter and val_max_iter count pairs, as in JAX."""

    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None, device="cuda",
                 time_steps: bool = False):
        if int(cfg.dp_size or 1) > 1:
            raise NotImplementedError("dp_size > 1: data parallelism (DDP) is a later slice of "
                                      "the port")
        if cfg.packed_batch and not cfg.host_pyramid:
            raise ValueError("packed_batch requires host_pyramid (data/packing.py)")
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
        pairs_per_epoch = min(len(self.train_dataset), cfg.training_max_iter)
        self.optimizer = make_optimizer(cfg, self.model,
                                        pairs_per_epoch if cfg.batch_size <= 1 else None)
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
        self.optimizer.set_epoch(self.start_epoch)
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
        batches = iterate_batches(self.train_dataset, cfg.batch_size, shuffle=True,
                                  seed=cfg.seed + epoch, max_items=cfg.training_max_iter,
                                  pack=self._pack(), device=self.device,
                                  num_workers=self._workers())
        self.step_times = []
        for it, batch in enumerate(batches):
            timer.tic()
            timings = {} if self.time_steps else None
            metrics = train_step(self.model, self.optimizer, batch, generator, timings)
            self.step += 1
            timer.toc()
            if timings is not None:
                self.step_times.append(timings)
            meters.update(metrics, n=batch_pairs(batch))
            if cfg.verbose and (it + 1) % cfg.verbose_freq == 0:
                self.logger.write(f"epoch {epoch} iter {it + 1}: {meters.summary()}, "
                                  f"{timer.avg:.3f}s/it\n")
                # running averages, as the reference's scalar stream records
                self.writer.write("train", self.step, meters.averages())
        self.optimizer.set_epoch(epoch + 1)
        return meters.averages()

    def _pack(self) -> int:
        return self.cfg.batch_size if self.cfg.packed_batch else 0

    def _workers(self) -> int:
        # more workers than cores is IPC overhead only (JAX's trainer)
        return min(int(self.cfg.num_workers), os.cpu_count() or 1)

    def eval_epoch(self, epoch: int) -> Dict[str, float]:
        meters = MetricMeters()
        self.model.eval()
        for batch in iterate_batches(self.val_dataset, self.cfg.batch_size,
                                     max_items=self.cfg.val_max_iter, pack=self._pack(),
                                     device=self.device, num_workers=self._workers()):
            meters.update(eval_step(self.model, batch), n=batch_pairs(batch))
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
