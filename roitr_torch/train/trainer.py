"""Training orchestration: epoch loop, running-average scalars, checkpoints.

Counterpart of roitr_tpu/train/trainer.py (reference lib/trainer.py:9-344):
train steps over a shuffled epoch, a validation pass, one checkpoint per
epoch and one per best metric under snapshot/<exp_dir>/checkpoints, and
resume from cfg.pretrain. A step takes `cfg.batch_size` same-bucket pairs
(a list of single pairs, or with `cfg.packed_batch` one packed pair, which
needs host pyramids) on each card, or on the CPU when asked, with the
kernels' plain versions. Pairs are prepared in min(cfg.num_workers,
cores // ranks on the host) worker subprocesses (data/worker_pool.py; 0:
in the loader's thread).

    trainer = Trainer(cfg)                  # device="cuda"; datasets from cfg
    best = trainer.train()

Data parallelism (`dp_size` > 1, or any process group) runs one process a
card (parallel/distributed.py), as JAX's `data` mesh takes a global batch
of batch_size pairs a device:

    torchrun --nproc_per_node=4 train.py    # each rank builds its Trainer

Each rank starts from rank 0's parameters, takes its stride of the
shuffled epoch, and joins each step's gradient reduction (even once its
own pairs have run out); only rank 0 logs and writes checkpoints.

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
import torch.distributed as dist

from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.loader import iterate_batches
from roitr_torch.models.roitr import RoITr, resolve_device
from roitr_torch.parallel.distributed import (
    barrier,
    broadcast_parameters,
    init_distributed,
    is_main,
    local_world,
    lockstep,
    rank,
    reduce_metrics,
    world,
)
from roitr_torch.parallel.train_step import (
    STEP_METRICS,
    batch_pairs,
    eval_step,
    make_optimizer,
    train_step,
)
from roitr_torch.train.checkpoint import (
    init_best_metrics,
    load_checkpoint,
    save_checkpoint,
    update_bests,
)
from roitr_torch.utils.logging import Logger, MetricMeters, ScalarWriter, Timer


class Trainer:
    """With `time_steps`, `step_times` holds the current epoch's per-step
    forward, backward and optimizer ms (and, in a process group, the
    all-reduce's); that synchronises the card at each border, so it is off
    by default.

    The learning rate falls once an epoch. At batch_size 1 an epoch is
    min(len(train set), training_max_iter) batches, and the staircase
    counts updates as JAX's does (optax.exponential_decay with
    transition_steps = pairs // iter_size). At batch_size B > 1 an epoch's
    number of batches depends on how its pairs fall into buckets (each
    bucket's ragged tail is a batch of its own), so the rate falls at each
    epoch's end (the reference's ExpLR); JAX's trainer gives its optimizer
    the epoch's pairs there, so its rate falls once in B epochs. Across
    several ranks the rate falls at each epoch's end too, for the same
    reason: JAX's optimizer is given the epoch's pairs, so on a mesh of D
    devices its rate falls once in D epochs.
    training_max_iter and val_max_iter count pairs, as in JAX, over all
    ranks together."""

    def __init__(self, cfg: Config, train_dataset=None, val_dataset=None, device="cuda",
                 time_steps: bool = False):
        if cfg.packed_batch and not cfg.host_pyramid:
            raise ValueError("packed_batch requires host_pyramid (data/packing.py)")
        self.cfg = cfg
        self.device = init_distributed(cfg, resolve_device(device))
        self.distributed = dist.is_initialized()
        self.rank, self.world, self.is_main = rank(), world(), is_main()
        self.train_dataset = (get_dataset(cfg, "train") if train_dataset is None
                              else train_dataset)
        self.val_dataset = get_dataset(cfg, "val") if val_dataset is None else val_dataset
        self.snapshot_dir = os.path.join("snapshot", cfg.exp_dir)
        self.ckpt_dir = os.path.join(self.snapshot_dir, "checkpoints")
        if self.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            self.logger = Logger(self.snapshot_dir)
            self.writer = ScalarWriter(self.snapshot_dir)

        self.model = RoITr(cfg, device=self.device, seed=cfg.seed)
        if self.distributed:
            broadcast_parameters(self.model)
        pairs_per_epoch = min(len(self.train_dataset), cfg.training_max_iter)
        self.optimizer = make_optimizer(
            cfg, self.model, pairs_per_epoch if cfg.batch_size <= 1 and self.world == 1 else None)
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
        self._log(f"resumed from {path} at epoch {self.start_epoch}\n")

    def _log(self, text: str) -> None:
        if self.is_main:
            self.logger.write(text)

    def _save(self, name: str, epoch: int) -> None:
        if self.is_main:
            save_checkpoint(os.path.join(self.ckpt_dir, f"{name}.pth"), self.model,
                            self.optimizer, self.step, epoch, self.best_metrics)

    def _batches(self, dataset, max_items: int, **kw):
        """This rank's batches of the first min(len, max_items) items of the
        (shuffled) order: its stride, as many items as the stride holds
        among them, so that the ranks together cover them once."""
        total = min(len(dataset), max_items)
        return iterate_batches(dataset, self.cfg.batch_size,
                               max_items=(total - self.rank + self.world - 1) // self.world,
                               pack=self._pack(), device=self.device,
                               num_workers=self._workers(), process_index=self.rank,
                               process_count=self.world, **kw)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        meters = MetricMeters()
        timer = Timer()
        # rank 0's noise is the one-process run's
        generator = torch.Generator().manual_seed(cfg.seed + epoch + 1_000_003 * self.rank)
        self.model.train()
        batches = self._batches(self.train_dataset, cfg.training_max_iter, shuffle=True,
                                seed=cfg.seed + epoch)
        if self.distributed:
            batches = lockstep(batches, self.device)
        self.step_times = []
        for it, batch in enumerate(batches):
            timer.tic()
            timings = {} if self.time_steps else None
            metrics = train_step(self.model, self.optimizer, batch, generator, timings)
            self.step += 1
            timer.toc()
            if timings is not None:
                self.step_times.append(timings)
            # a distributed step's metrics are the means over all ranks' pairs
            n = int(metrics.pop("pairs")) if self.distributed else batch_pairs(batch)
            meters.update(metrics, n=n)
            if self.is_main and cfg.verbose and (it + 1) % cfg.verbose_freq == 0:
                self._log(f"epoch {epoch} iter {it + 1}: {meters.summary()}, "
                          f"{timer.avg:.3f}s/it\n")
                # running averages, as the reference's scalar stream records
                self.writer.write("train", self.step, meters.averages())
        self.optimizer.set_epoch(epoch + 1)
        return meters.averages()

    def _pack(self) -> int:
        return self.cfg.batch_size if self.cfg.packed_batch else 0

    def _workers(self) -> int:
        # more workers than cores is IPC overhead only (JAX's trainer); the
        # host's ranks share its cores
        return min(int(self.cfg.num_workers), (os.cpu_count() or 1) // local_world())

    def eval_epoch(self, epoch: int) -> Dict[str, float]:
        """The validation pass; across ranks its metrics are the pair-weighted
        means over every rank's pairs, the same on every rank."""
        meters = MetricMeters()
        self.model.eval()
        for batch in self._batches(self.val_dataset, self.cfg.val_max_iter):
            meters.update(eval_step(self.model, batch), n=batch_pairs(batch))
        avgs = reduce_metrics(meters, STEP_METRICS, self.device)
        if self.is_main:
            self._log(f"epoch {epoch} val: "
                      + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(avgs.items())) + "\n")
            self.writer.write("val", self.step, avgs)
        return avgs

    def train(self) -> Dict[str, float]:
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            self._log(f"epoch {epoch} train done in {time.time() - t0:.0f}s: "
                      + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(train_metrics.items()))
                      + "\n")
            improved = update_bests(self.best_metrics, self.eval_epoch(epoch))
            self._save(f"model_{epoch}", epoch)
            for name, better in improved.items():
                if better:
                    self._save(f"model_best_{name}", epoch)
            barrier()
        return self.best_metrics

    def eval(self) -> Dict[str, float]:
        return self.eval_epoch(self.start_epoch)
