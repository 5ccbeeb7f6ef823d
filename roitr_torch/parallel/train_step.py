"""The train and eval steps, and the optimizer of the reference.

Counterpart of roitr_tpu/parallel/train_step.py (reference
lib/trainer.py:169-267, main.py:79-100): forward, the two losses, backward
through every parameter, and Adam (or SGD) with coupled L2, a per-epoch
staircase ExpLR and `iter_size` gradient averaging, on one card. A step
takes one pair, a packed batch of B pairs (data/packing.py: one forward,
outputs with a leading B) or a list of B single pairs (the loader's
`batch_size > 1` without packing); its loss and metrics are the means of
the pairs' (JAX's vmap over pairs, then `jnp.mean`). Data parallelism is a
later slice of the port.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import torch

from roitr_torch.losses import evaluate, overall_loss
from roitr_torch.models.roitr import PairInputs, RoITr


class TrainOptimizer:
    """The JAX package's optax chain (`make_optimizer`) in torch terms.

    - Adam(betas (0.9, 0.99), eps 1e-8) or SGD(momentum), with the L2 term
      `weight_decay * p` added to the gradient before the moments (torch's
      coupled weight_decay, optax.add_decayed_weights first in the chain).
    - lr = cfg.lr * gamma ** (k // T) for the k-th update, T =
      steps_per_epoch // iter_size (optax.exponential_decay, staircase).
    - With iter_size > 1, the gradients of iter_size mini-steps are averaged
      and one update is made (optax.MultiSteps); parameters hold in between.

    Every parameter takes part in every update, a zero gradient where
    backward gave none (as in optax, where L2 and the moments still move).
    """

    def __init__(self, params, cfg, steps_per_epoch: int):
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
        transition = max(steps_per_epoch // self.iter_size, 1)
        gamma = cfg.scheduler_gamma
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.inner, lambda k: gamma ** (k // transition))
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

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "scheduler": self.scheduler.state_dict(),
                "mini_step": self.mini_step, "acc": self._acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.mini_step = state["mini_step"]
        self._acc = state["acc"]


def make_optimizer(cfg, model: torch.nn.Module, steps_per_epoch: int) -> TrainOptimizer:
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


def train_step(model: RoITr, optimizer: TrainOptimizer, batch: Batch,
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
    (summed over a list's pairs)."""
    cfg = model.cfg
    laps = _Laps(model.device, timings)
    pairs = batch if isinstance(batch, list) else [batch]
    per_pair = []
    for pair in pairs:
        out = model(pair, train=True, with_gt=True, generator=generator)
        losses = _pair_losses(cfg, out, pair.rot, pair.trans)
        laps.lap("forward_ms")
        (losses["loss"] / len(pairs)).backward()
        laps.lap("backward_ms")
        per_pair.append({k: v.detach() for k, v in losses.items()})
    metrics = {k: torch.stack([m[k] for m in per_pair]).mean() for k in per_pair[0]}
    with torch.no_grad():  # one pass over every gradient element, as JAX's guard
        flat = torch.cat([torch.stack([m["loss"] for m in per_pair])] + [
            p.grad.reshape(-1) for p in optimizer.params if p.grad is not None])
        grads_finite = bool(torch.isfinite(flat).all())
    optimizer.step(grads_finite)
    laps.lap("optimizer_ms")
    result = {k: float(v) for k, v in metrics.items()}
    result["grads_finite"] = float(grads_finite)
    return result


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
