"""Training: `train_step` on one pair a step, from a seeded pool of
prepared pairs that `data/loader.py` `iterate_batches` shuffles an epoch
(seeded) and copies to the card on its prefetch thread; the optimizer is
`make_optimizer`'s Adam with `iter_size` averaging.

Set-up drives the first updates (`follow_updates` of them, `iter_size`
pairs each) through the window's own call and feed; the reference follows
them from the same weights, pairs and Gumbel noise. Traffic keys: pool,
points, overlap, pairs ("surface" or "flow"), follow_updates, trace_steps.
"""

from __future__ import annotations

import sys
import torch

from portbench import pools


class Driver:
    train = True

    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic

    def setup(self) -> None:
        from roitr_torch.data.loader import iterate_batches
        from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
        from roitr_torch.models.roitr import RoITr
        from roitr_torch.parallel.train_step import make_optimizer, train_step

        ctx, t = self.ctx, self.traffic
        cfg = ctx.port_cfg
        k = cfg.normal_knn
        normals = lambda p: normal_redirect_np(p, estimate_normals_np(p, k), (0.0, 0.0, 0.0))  # noqa: E731
        self.items = pools.train_items(ctx.seed, t, cfg.buckets, normals)
        self._iterate, self._train_step = iterate_batches, train_step
        self.model = RoITr(cfg, device=ctx.device)
        self.model.load_state_dict(ctx.state_dict)
        self.model.train()
        self.optimizer = make_optimizer(cfg, self.model, steps_per_epoch=cfg.training_max_iter)
        self.generator = torch.Generator().manual_seed(pools.seed32(ctx.seed, 4))
        self.iter_size = max(cfg.iter_size, 1)
        self.epoch, self.k = 0, 0
        self.ran = []  # (source, target) valid points of each pair stepped
        self.batches = self._epoch()
        self.failed = 0
        # the first updates, kept for the reference to follow
        params = dict(self.model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grads = [], None
        for j in range(t["follow_updates"] * self.iter_size):
            losses.append(self.step(record=False)["loss"])
            if j == self.iter_size - 1:
                # Adam's first moment after one update is (1 - beta1) g; a leaf
                # without one received no gradient
                state = self.optimizer.inner.state
                grads = {n: float(torch.linalg.norm(state[p]["exp_avg"] / (1.0 - 0.9)))
                         if "exp_avg" in state.get(p, {}) else 0.0 for n, p in params.items()}
        deltas = {n: float(torch.linalg.norm(p.detach() - start[n])) for n, p in params.items()}
        self.follow = {"losses": losses, "grad_norms": grads, "delta_norms": deltas}
        del start

    def _epoch(self):
        """The loader's batches of the next epoch, each with its pair's
        valid point counts (the loader's order is pools.epoch_order)."""
        e = self.epoch
        self.epoch += 1
        batches = self._iterate(self.items, 1, shuffle=True,
                                seed=pools.seed32(self.ctx.seed, 100 + e), device=self.ctx.device)
        return zip(batches, pools.item_counts(self.items, pools.epoch_order(
            self.ctx.seed, e, len(self.items))))

    def _next(self):
        try:
            batch, counts = next(self.batches)
        except StopIteration:
            self.batches = self._epoch()
            batch, counts = next(self.batches)
        self.ran.append(counts)
        return batch

    def bucket(self) -> int:
        return int(self.items[0]["src_points"].shape[0])

    def boundary(self) -> bool:
        return self.k % self.iter_size == 0

    def step(self, timings=None, record=True):
        metrics = self._train_step(self.model, self.optimizer, self._next(), self.generator,
                                   timings)
        self.k += 1
        if metrics["grads_finite"] != 1.0:
            self.failed += 1
        return 1 if record else metrics

    def payload(self) -> dict:
        return dict(self.follow)

    def close(self) -> None:
        self.batches = None
        self.model = self.optimizer = self.items = None


def reference_numbers(ctx, payload, model, device) -> dict:
    """The reference follows the first updates from the same weights,
    pairs (recomputing their normals) and Gumbel noise."""
    from portbench import judge
    from portbench.reference import ops, pipeline

    k = ctx.ref_cfg.normal_knn
    pool = ctx.traffic["pool"]
    n = ctx.traffic["follow_updates"] * max(ctx.ref_cfg.iter_size, 1)
    order = []
    while len(order) < n:
        order += list(pools.epoch_order(ctx.seed, len(order) // pool, pool))
    order = order[:n]
    items = pools.train_items(ctx.seed, ctx.traffic, ctx.ref_cfg.buckets,
                              lambda p: ops.estimate_normals_host(p, k), select=set(order))
    generator = torch.Generator().manual_seed(pools.seed32(ctx.seed, 4))
    ref = pipeline.follow_training(model, ctx.ref_cfg, [items[i] for i in order], generator,
                                   ctx.traffic["follow_updates"], device)
    print("[reference] " + judge.train_report(payload, ref), file=sys.stderr, flush=True)
    return judge.train_numbers(payload, ref)

