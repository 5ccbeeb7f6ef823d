"""Data-parallel training: one process a card, joined by the program's
`parallel/distributed.py` `spawn` (NCCL on cards, gloo on the CPU), each
rank stepping `train_step` on one pair of its stride of the seeded,
loader-shuffled pool a step, through the program's `lockstep`, with one
all-reduce of the flat gradient buffer a step.

Set-up, on every rank: the weights from the seed, its pairs with host
normals, the model, the optimizer (the Trainer's, with the rate falling
once an epoch at world > 1), and the first update, which the reference
follows from the same four pairs and Gumbel noise (one generator a rank).
The window starts on a barrier and runs harness.measure's loop on every
rank; rank 0's clock decides, through one all-reduce of two flags a step,
when every rank stops and when the traced stretch starts. Each rank checks
after its window that it holds no module of JAX or the JAX package.
Traffic keys: as `train`, plus ranks.
"""

from __future__ import annotations

import itertools
import sys
import time

import torch

from portbench import pools


def _rank(rank: int, world: int, job: dict) -> dict:
    """One rank's set-up, window and traced stretch; returns its records,
    trace summary, laps, memory peak and (rank 0) the followed update."""
    import torch.distributed as dist

    from roitr_torch.data.loader import iterate_batches
    from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
    from roitr_torch.models.roitr import RoITr
    from roitr_torch.parallel.distributed import broadcast_parameters, lockstep
    from roitr_torch.parallel.train_step import make_optimizer, train_step

    from portbench import harness, models

    import os

    # the host's cores shared out among the ranks, as one process a card would have them
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    cuda = torch.cuda.is_available() and job["device"] != "cpu"
    device = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.make_context(job["bench"], job["cell"], job["seed"], device, job["overrides"])
    cfg = ctx.model.program_config(ctx.values)
    t = ctx.traffic
    k = cfg.normal_knn
    items = pools.train_items(ctx.seed, t, cfg.buckets, lambda p: normal_redirect_np(
        p, estimate_normals_np(p, k), (0.0, 0.0, 0.0)))
    model = RoITr(cfg, device=device)
    model.load_state_dict(models.weights(ctx))
    broadcast_parameters(model)
    model.train()
    optimizer = make_optimizer(cfg, model, steps_per_epoch=None)
    generator = torch.Generator().manual_seed(pools.seed32(ctx.seed, 40 + rank))

    def batches():
        """This rank's batches, epoch after epoch, each with its pair's
        valid point counts."""
        for e in itertools.count():
            order = pools.epoch_order(ctx.seed, e, len(items))[rank::world]
            loader = iterate_batches(items, 1, shuffle=True, seed=pools.seed32(ctx.seed, 100 + e),
                                     device=device, process_index=rank, process_count=world)
            yield from zip(loader, pools.item_counts(items, order))

    driver = _RankDriver(rank, world, device, model, optimizer, generator,
                         lockstep(batches(), device), train_step, items)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    first = driver.run_step()
    adam = optimizer.inner.state
    follow = {"losses": [first["loss"]],
              "grad_norms": {n: float(torch.linalg.norm(adam[p]["exp_avg"] / (1.0 - 0.9)))
                             if "exp_avg" in adam.get(p, {}) else 0.0
                             for n, p in params.items()},
              "delta_norms": {n: float(torch.linalg.norm(p.detach() - start[n]))
                              for n, p in params.items()}}
    del start
    if cuda:
        torch.cuda.synchronize()
    dist.barrier()
    setup_end = time.time()
    log = (lambda *a: print(*a, file=sys.stderr, flush=True)) if rank == 0 else (lambda *a: None)
    run = harness.measure(ctx, driver, job["seconds"], job["trace"], 0.0, log)
    return {"records": run.records, "window_s": run.window_s, "setup_end": setup_end,
            "trace": run.trace, "laps": run.laps,
            "peak": int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
            "failed": run.failed, "follow": follow if rank == 0 else None,
            "bucket": run.bucket, "forbidden": harness.loaded_forbidden()}


class _RankDriver:
    """One rank's steps for harness.measure: a pair of the rank's stride a
    step, `world` pairs over all ranks; rank 0's clock decides when the
    traced stretch starts and when every rank stops, through one
    all-reduce of two flags a step (a host sync a step, part of what the
    cell times)."""

    train = True

    def __init__(self, rank, world, device, model, optimizer, generator, stream, step_fn,
                 items):
        self.rank, self.world, self.device = rank, world, device
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.stream, self.step_fn, self.items = stream, step_fn, items
        self.flag = torch.zeros(2, device=device)
        self.ran, self.failed = [], 0

    def bucket(self) -> int:
        return int(self.items[0]["src_points"].shape[0])

    def boundary(self) -> bool:
        return True

    def agree(self, stop: bool, stretch: bool):
        import torch.distributed as dist

        self.flag[0] = float(self.rank == 0 and stop)
        self.flag[1] = float(self.rank == 0 and stretch)
        dist.all_reduce(self.flag, op=dist.ReduceOp.MAX)
        stop, stretch = self.flag.tolist()
        return bool(stop), bool(stretch)

    def run_step(self, timings=None) -> dict:
        batch, counts = next(self.stream)
        metrics = self.step_fn(self.model, self.optimizer, batch, self.generator, timings)
        self.ran.append(counts)
        if metrics["grads_finite"] != 1.0:
            self.failed += 1
        return metrics

    def step(self, timings=None) -> int:
        self.run_step(timings)
        return self.world


def run(ctx, seconds: float, trace: bool, t_start_age: float, bench: dict, overrides,
        log=print):
    """All ranks' run; returns (harness.Run, the followed update)."""
    from roitr_torch.parallel.distributed import spawn

    from portbench import harness

    world = int(ctx.traffic["ranks"])
    on_cards = str(ctx.device) != "cpu"
    devices = [f"cuda:{r}" for r in range(world)] if on_cards else ["cpu"] * world
    process_start = time.time() - (harness.process_age_s() - t_start_age)
    job = {"bench": bench, "cell": ctx.cell, "seed": ctx.seed, "seconds": seconds,
           "trace": trace, "overrides": overrides, "device": str(ctx.device)}
    outs = spawn(_rank, world, "nccl" if on_cards else "gloo", args=(job,), devices=devices,
                 timeout_s=seconds + 600)
    found = sorted({name for o in outs for name in o["forbidden"]})
    if found:
        raise SystemExit(f"modules of {found} are loaded in a rank after the window")
    head = outs[0]
    summary = head["trace"]
    if summary is not None:
        summary = dict(summary, busy_s=sum(o["trace"]["busy_s"] for o in outs) / world,
                       window_s=sum(o["trace"]["window_s"] for o in outs) / world)
    laps = head["laps"]
    if laps is not None:
        laps = {key: sum(o["laps"][key] for o in outs) / world for key in laps}
    # each step's pairs over every rank (lockstep: the ranks' records align)
    records = [r[:4] + (sum((o["records"][j][4] for o in outs), ()),)
               for j, r in enumerate(head["records"])]
    log(f"[window] {head['window_s']:.3f} s, {len(records)} steps of {world} ranks, "
        f"{sum(r[2] for r in records)} pairs")
    run = harness.Run(ctx=ctx, train=True, bucket=head["bucket"],
                      setup_s=max(o["setup_end"] for o in outs) - process_start,
                      records=records, window_s=head["window_s"],
                      attempted=sum(r[2] for r in records), failed=sum(o["failed"] for o in outs),
                      trace=summary, laps=laps, memory_peak_bytes=max(o["peak"] for o in outs))
    return run, head["follow"]


def reference_numbers(ctx, payload, model, device) -> dict:
    """The reference takes the first step's pairs of every rank (rank r's
    first pair is the r-th of epoch 0's order) as one update averaging
    them, with each rank's Gumbel noise, and compares the step's mean loss
    and the update."""
    import copy

    from portbench import judge
    from portbench.reference import ops, pipeline

    world = int(ctx.traffic["ranks"])
    order = pools.epoch_order(ctx.seed, 0, ctx.traffic["pool"])[:world]
    k = ctx.ref_cfg.normal_knn
    items = pools.train_items(ctx.seed, ctx.traffic, ctx.ref_cfg.buckets,
                              lambda p: ops.estimate_normals_host(p, k), select=set(order))
    cfg = copy.copy(ctx.ref_cfg)
    cfg.iter_size = world
    gens = [torch.Generator().manual_seed(pools.seed32(ctx.seed, 40 + r)) for r in range(world)]
    ref = pipeline.follow_training(model, cfg, [items[i] for i in order], gens, 1, device)
    ref["losses"] = [sum(ref["losses"]) / world]
    print("[reference] " + judge.train_report(payload, ref), file=sys.stderr, flush=True)
    return judge.train_numbers(payload, ref)

