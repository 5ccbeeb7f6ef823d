"""The train and eval steps, and the optimizer of the reference.

Counterpart of roitr_tpu/parallel/train_step.py (reference
lib/trainer.py:169-267, main.py:79-100): forward, the two losses, backward
through every parameter, and Adam (or SGD) with coupled L2, a per-epoch
staircase ExpLR and `iter_size` gradient averaging, on one card. A step
takes one pair, a packed batch of B pairs (data/packing.py: one forward,
outputs with a leading B) or a list of B single pairs (the loader's
`batch_size > 1` without packing); its loss and metrics are the means of
the pairs' (JAX's vmap over pairs, then `jnp.mean`). Under bf16 compute
(`compute_dtype`) the losses and metrics are fp32, the optimizer updates
fp32 parameters and the NaN guard reads every fp32 gradient; there is no
loss scaling, as in JAX. Under data parallelism (one process a card,
parallel/distributed.py) each rank's gradient and metrics are reduced in one
all-reduce before the guard and the update, whenever a process group is
initialized.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist

from roitr_torch.losses import evaluate, overall_loss
from roitr_torch.models.roitr import PairInputs, RoITr
from roitr_torch.parallel.distributed import all_reduce_weighted_


class TrainOptimizer:
    """The JAX package's optax chain (`make_optimizer`) in torch terms.

    - Adam(betas (0.9, 0.99), eps 1e-8) or SGD(momentum), with the L2 term
      `weight_decay * p` added to the gradient before the moments (torch's
      coupled weight_decay, optax.add_decayed_weights first in the chain).
    - With `steps_per_epoch`, lr = cfg.lr * gamma ** (k // T) for the k-th
      update, T = steps_per_epoch // iter_size (optax.exponential_decay,
      staircase). Without it, lr = cfg.lr * gamma ** e once `set_epoch(e)`
      says e epochs are done (the reference's ExpLR, stepped once an
      epoch).
    - With iter_size > 1, the gradients of iter_size mini-steps are averaged
      and one update is made (optax.MultiSteps); parameters hold in between.

    Every parameter takes part in every update, a zero gradient where
    backward gave none (as in optax, where L2 and the moments still move).
    """

    def __init__(self, params, cfg, steps_per_epoch: Optional[int] = None):
        self.params = [p for p in params if p.requires_grad]
        name = cfg.optimizer.upper()
        if name == "ADAM":
            self.inner = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-8,
                                          weight_decay=cfg.weight_decay)
        elif name == "SGD":
            self.inner = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum,
                                         weight_decay=cfg.weight_decay)
        else:
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} (reference main.py:93)")
        self.iter_size = max(cfg.iter_size, 1)
        self.gamma = cfg.scheduler_gamma
        self.epochs = 0
        self.transition = (None if steps_per_epoch is None
                           else max(steps_per_epoch // self.iter_size, 1))
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.inner, lambda k: self.gamma ** self._stair(k))
        self.mini_step = 0
        self._acc: Optional[list] = None

    def _grads(self, finite: bool):
        return [p.grad if finite and p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def step(self, grads_finite: bool) -> bool:
        """Take the gradients one mini-step left in `.grad` and clear them.
        Returns whether an update was made. A step whose gradients are not
        finite counts with zero gradients, and the parameters are restored
        after its update (the JAX NaN guard): the moments, the schedule and
        the L2 term still move, the parameters do not."""
        grads = self._grads(grads_finite)
        if self.iter_size > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self._acc, grads):
                a.add_(g)
            self.mini_step += 1
            if self.mini_step < self.iter_size:
                self.inner.zero_grad(set_to_none=True)
                return False
            grads = [a / self.iter_size for a in self._acc]
            self._acc = None
            self.mini_step = 0
        for p, g in zip(self.params, grads):
            p.grad = g
        held = None if grads_finite else [p.detach().clone() for p in self.params]
        self.inner.step()
        self.scheduler.step()
        if held is not None:
            with torch.no_grad():
                for p, old in zip(self.params, held):
                    p.copy_(old)
        self.inner.zero_grad(set_to_none=True)
        return True

    def _stair(self, updates: int) -> int:
        return self.epochs if self.transition is None else updates // self.transition

    def set_epoch(self, epochs: int) -> None:
        """`epochs` epochs are done. Without steps_per_epoch the rate is
        gamma ** epochs from the next update on; with it, the update count
        sets the rate."""
        self.epochs = epochs
        if self.transition is None:
            for group, base in zip(self.inner.param_groups, self.scheduler.base_lrs):
                group["lr"] = base * self.gamma ** self.epochs

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "scheduler": self.scheduler.state_dict(),
                "mini_step": self.mini_step, "acc": self._acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = state["mini_step"]
        self._acc = state["acc"]


def make_optimizer(cfg, model: torch.nn.Module,
                   steps_per_epoch: Optional[int] = None) -> TrainOptimizer:
    return TrainOptimizer(model.parameters(), cfg, steps_per_epoch)


Batch = Union[PairInputs, List[PairInputs]]


def _pair_losses(cfg, out, rot, trans) -> Dict[str, torch.Tensor]:
    """overall_loss and evaluate of one forward's output, each a 0-d tensor.
    A packed output (a leading B on every entry) gets both per pair, on the
    (B, ...) slices, then the mean of each over B (JAX's
    `jax.vmap(lm)(out, pair.rot, pair.trans)` and `jnp.mean`); the
    evaluator's metrics carry no gradient."""
    if rot.ndim == 2:
        losses = overall_loss(cfg, out, rot, trans)
        with torch.no_grad():
            return {**losses, **evaluate(cfg, out, rot, trans)}
    per_pair = []
    for i in range(rot.shape[0]):
        o = {k: v[i] for k, v in out.items()}
        losses = overall_loss(cfg, o, rot[i], trans[i])
        with torch.no_grad():
            per_pair.append({**losses, **evaluate(cfg, o, rot[i], trans[i])})
    return {k: torch.stack([m[k] for m in per_pair]).mean() for k in per_pair[0]}


def batch_pairs(batch: Batch) -> int:
    """Pairs in a batch: 1, B of a packed pair, or the sum over a list."""
    if isinstance(batch, list):
        return sum(batch_pairs(p) for p in batch)
    return int(batch.src_count.shape[0]) if batch.src_count.ndim == 1 else 1


class _Laps:
    """Milliseconds between laps, synchronising the card at each lap."""

    def __init__(self, device: torch.device, out: Optional[dict]):
        self.device, self.out = device, out
        self.t = self._now() if out is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, name: str) -> None:
        """Add the ms since the last lap to out[name]."""
        if self.out is not None:
            t = self._now()
            self.out[name] = self.out.get(name, 0.0) + (t - self.t) * 1e3
            self.t = t


# the metrics of a train or eval step, in the order the process group reduces them
STEP_METRICS = ("loss", "c_loss", "f_loss", "o_loss", "PIR", "IR")


def train_step(model: RoITr, optimizer: TrainOptimizer, batch: Optional[Batch],
               generator: torch.Generator, timings: Optional[dict] = None) -> Dict[str, float]:
    """One batch through forward, losses, backward and the optimizer; returns
    the means over its pairs of loss, c_loss, f_loss, o_loss, PIR and IR,
    and grads_finite (1.0 or 0.0). The gradient is that of the mean loss:
    a packed pair runs one forward and one backward; a list of B pairs runs
    the pairs one at a time, each backward of its loss over B adding into
    the gradients, so that one pair's graph is alive at a time (the peak
    of one pair, not of B). `generator` (CPU) draws the GT patch sampling's
    Gumbel noise, pair by pair in batch order. JAX's NaN guard covers the
    losses and every gradient: one pair's non-finite loss skips the update.
    Given a dict, `timings` receives the forward, backward and optimizer ms
    (summed over a list's pairs).

    In a process group (parallel/distributed.py), `batch` is this rank's
    share of a step of the group (None when its loader has run out: it
    joins with no pairs, `lockstep`). Every gradient and the
    metrics, each times the rank's pairs n_r, go into one flat buffer that
    one all-reduce sums over the ranks; dividing by the sum of n_r gives
    the means over the step's pairs (JAX's mean over its global batch,
    exact when ranks hold different counts). The guard reads that reduced
    buffer, so every rank makes the same update; the metrics returned are
    the step's, with its pair count under "pairs"; `timings` also receives
    the all-reduce's ms."""
    distributed = dist.is_initialized()
    if batch is None and not distributed:
        raise ValueError("train_step needs a batch (None only in a process group)")
    cfg = model.cfg
    laps = _Laps(model.device, timings)
    pairs = [] if batch is None else batch if isinstance(batch, list) else [batch]
    per_pair = []
    for pair in pairs:
        out = model(pair, train=True, with_gt=True, generator=generator)
        losses = _pair_losses(cfg, out, pair.rot, pair.trans)
        laps.lap("forward_ms")
        (losses["loss"] / len(pairs)).backward()
        laps.lap("backward_ms")
        per_pair.append({k: v.detach() for k, v in losses.items()})
    with torch.no_grad():
        if distributed:
            metrics, grads_finite = _reduce_step(optimizer, per_pair, batch, model.device)
            laps.lap("allreduce_ms")
        else:
            metrics = {k: torch.stack([m[k] for m in per_pair]).mean() for k in per_pair[0]}
            # one pass over every gradient element, as JAX's guard
            flat = torch.cat([torch.stack([m["loss"] for m in per_pair])] + [
                p.grad.reshape(-1) for p in optimizer.params if p.grad is not None])
            grads_finite = bool(torch.isfinite(flat).all())
    optimizer.step(grads_finite)
    laps.lap("optimizer_ms")
    result = {k: float(v) for k, v in metrics.items()}
    result["grads_finite"] = float(grads_finite)
    return result


def _reduce_step(optimizer: TrainOptimizer, per_pair: List[Dict[str, torch.Tensor]],
                 batch: Optional[Batch], device: torch.device):
    """The distributed half of train_step: (the step's metrics, whether the
    reduced buffer is finite), with every parameter's .grad set to its
    slice of the reduced buffer."""
    n = 0 if batch is None else batch_pairs(batch)
    params = optimizer.params
    if per_pair:
        mean = torch.stack([torch.stack([m[k] for m in per_pair]).mean() for k in STEP_METRICS])
    else:
        mean = torch.zeros(len(STEP_METRICS), device=device)
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                      else torch.zeros(p.numel(), device=p.device) for p in params]
                     + [mean.to(params[0].dtype)])
    total = all_reduce_weighted_(flat, n)
    grads_finite = bool(torch.isfinite(flat).all())
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    metrics = dict(zip(STEP_METRICS, flat[offset:]))
    metrics["pairs"] = total
    return metrics, grads_finite


@torch.no_grad()
def eval_step(model: RoITr, batch: Batch) -> Dict[str, float]:
    """Losses and metrics on the validation path (train=False,
    with_gt=True: estimated patches, no sampling): one pair's, or the means
    over the pairs of a packed pair or a list."""
    pairs = batch if isinstance(batch, list) else [batch]
    per_pair = []
    for pair in pairs:
        out = model(pair, train=False, with_gt=True)
        metrics = _pair_losses(model.cfg, out, pair.rot, pair.trans)
        per_pair.extend([metrics] * batch_pairs(pair))
    return {k: float(torch.stack([m[k] for m in per_pair]).mean()) for k in per_pair[0]}
