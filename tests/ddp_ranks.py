"""Rank functions for tests/test_torch_ddp.py, which starts them with
roitr_torch.parallel.distributed `spawn`. A module of their own that
imports neither JAX nor roitr_tpu, so that a spawned rank pays only for
torch and the port.

`ddp_checks` runs every check of that file that needs a process group, in
one group on the CPU (gloo), and returns what the tests compare: digests
and flat copies of the parameters as numpy arrays (a tensor sent through a
queue would be shared memory of a process about to exit). `card_step` is
the rank of the card's step, which tests/test_torch_cuda.py and
chip_smoke.py's [ddp] spawn, and which share `flat_params`,
`capture_grads` and `digest` with this file's checks.
"""

import hashlib
import os
import time

import numpy as np
import torch

from roitr_torch.config import Config
from roitr_torch.data.loader import dict_to_pair
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.models.roitr import RoITr
from roitr_torch.parallel import train_step as train_step_module
from roitr_torch.parallel.distributed import (
    barrier,
    broadcast_parameters,
    init_distributed,
    lockstep,
)
from roitr_torch.parallel.train_step import make_optimizer, train_step

CPU = torch.device("cpu")


def flat_params(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu().numpy().copy()


def capture_grads(opt) -> list:
    """The flat gradient each optimizer step is given (zeros where a
    parameter has none), appended to the list returned."""
    grads, step = [], opt.step

    def wrapped(finite):
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .reshape(-1) for p in opt.params]).cpu().numpy())
        return step(finite)

    opt.step = wrapped
    return grads


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def generator(state: np.ndarray) -> torch.Generator:
    gen = torch.Generator()
    gen.set_state(torch.from_numpy(state))
    return gen


def _model(cfg):
    """The seeded model, rank 0's parameters on every rank, and its Adam."""
    model = RoITr(cfg, device="cpu", seed=cfg.seed)
    if torch.distributed.get_rank():  # a rank whose own init differs: the broadcast must fix it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    broadcast_parameters(model)
    return model, make_optimizer(cfg, model, steps_per_epoch=4)


def _steps(cfg, batches, states):
    """Train steps in lockstep over this rank's `batches`, the k-th drawing
    its Gumbel noise from generator state states[k]: the flat parameters
    after each step, and each step's metrics."""
    model, opt = _model(cfg)
    flats, metrics = [], []
    for k, batch in enumerate(lockstep(batches, CPU)):
        gen = generator(states[k]) if batch is not None else torch.Generator()
        metrics.append(train_step(model, opt, batch, gen))
        flats.append(flat_params(model))
    return flats, metrics


def _nan_step(cfg, rank, pair, state):
    """One step whose pair's loss on rank 1 is not finite."""
    model, opt = _model(cfg)
    before = flat_params(model)
    pair_losses = train_step_module._pair_losses

    def nan_loss(*args):
        losses = pair_losses(*args)
        losses["loss"] = losses["loss"] * float("nan")
        return losses

    if rank == 1:
        train_step_module._pair_losses = nan_loss
    try:
        metrics = train_step(model, opt, pair, generator(state))
    finally:
        train_step_module._pair_losses = pair_losses
    return dict(unchanged=bool(np.array_equal(before, flat_params(model))), metrics=metrics,
                updates=opt.scheduler.last_epoch)


def _trainer(cfg, base):
    """A Trainer over three train and three validation pairs (rank 0 holds
    2 of each, rank 1 one), counting its checkpoint writes; then a second
    one resumed from its epoch's checkpoint trains one more epoch."""
    from roitr_torch.train import trainer as trainer_module

    saves = []
    save = trainer_module.save_checkpoint
    trainer_module.save_checkpoint = lambda path, *a: (saves.append(os.path.basename(path)),
                                                       save(path, *a))
    os.chdir(base)
    train_set = SyntheticPairs(3, 256, seed=0, normal_knn=9)
    val_set = SyntheticPairs(3, 256, seed=50, normal_knn=9)
    try:
        trainer = trainer_module.Trainer(cfg, train_set, val_set, device="cpu")
        lr0 = trainer.optimizer.inner.param_groups[0]["lr"]
        best = trainer.train()
        flat = flat_params(trainer.model)
        ckpts, first_saves = sorted(os.listdir(trainer.ckpt_dir)), list(saves)
        barrier()  # every rank has listed them before the resumed run adds model_1
        resumed = trainer_module.Trainer(
            cfg.replace(pretrain=os.path.join(trainer.ckpt_dir, "model_0.pth"), max_epoch=2),
            train_set, val_set, device="cpu")
        resumed_equal = bool(np.array_equal(flat_params(resumed.model), flat))
        start = resumed.start_epoch
        resumed.train()
    finally:
        trainer_module.save_checkpoint = save
    return dict(flat=flat, best=best, steps=trainer.step, ckpts=ckpts, saves=first_saves,
                lr=(lr0, trainer.optimizer.inner.param_groups[0]["lr"]),
                logger=hasattr(trainer, "logger"), resumed_equal=resumed_equal,
                resumed_start=start, resumed_steps=resumed.step,
                resumed_digest=digest(flat_params(resumed.model)))


def write_tester_dumps(cfg, base, n=4):
    """The Tester on n synthetic pairs with the seed-0 weights; dumps under
    base/snapshot/<exp_dir>/<benchmark>."""
    from roitr_torch.eval.tester import Tester

    os.chdir(base)
    state_dict = RoITr(cfg, device="cpu", seed=0).state_dict()
    Tester(cfg, dataset=SyntheticPairs(n, 128, counts=(90, 128), normal_knn=9), device="cpu",
           state_dict=state_dict).test()


TESTERS = {"world2": {}, "packed2": dict(packed_batch=True, batch_size=2, device_prep=True)}


def config_for_tester(small, name, **kw):
    return Config(**small).replace(mode="test", exp_dir=name,
                                   fine_matching_confidence_threshold=0.0, **kw)


def _mesh_step(cfg, rank, pair):
    """One step of one pair a rank from the seed-0 weights (those converted
    into JAX's parameters): the reduced gradient (rank 0's), its digest
    and the step's metrics."""
    model = RoITr(cfg, device="cpu", seed=0)
    broadcast_parameters(model)
    opt = make_optimizer(cfg, model, steps_per_epoch=1)
    grads = capture_grads(opt)
    metrics = train_step(model, opt, dict_to_pair(pair), torch.Generator().manual_seed(rank))
    return dict(grad=grads[0] if rank == 0 else None, grad_digest=digest(grads[0]),
                metrics=metrics)


def ddp_checks(rank, world, base, small, pairs, states, mesh_kw, mesh_pairs):
    """Every check of tests/test_torch_ddp.py that needs a process group."""
    torch.set_num_threads(1)
    cfg = Config(**small)
    out = {"device": str(init_distributed(cfg.replace(dp_size=world), "cpu"))}
    try:
        init_distributed(cfg.replace(dp_size=world + 1), "cpu")
    except ValueError as e:
        out["dp_mismatch"] = str(e)
    batches = [[dict_to_pair(pairs[0]), dict_to_pair(pairs[2])], [dict_to_pair(pairs[1])]][rank]
    flats, out["metrics"] = _steps(cfg, batches, states[rank])
    out["digests"] = [digest(f) for f in flats]
    out["flats"] = flats if rank == 0 else None  # rank 1's are held to rank 0's by digest
    out["nan"] = _nan_step(cfg, rank, dict_to_pair(pairs[rank]), states[rank][0])
    out["mesh"] = _mesh_step(Config(**mesh_kw), rank, mesh_pairs[rank])
    trainer = _trainer(cfg.replace(exp_dir="trainer", scheduler_gamma=0.5, training_max_iter=3,
                                   val_max_iter=3, max_epoch=1), base)
    trainer["digest"] = digest(trainer["flat"])
    if rank:
        trainer["flat"] = None
    out["trainer"] = trainer
    for name, kw in TESTERS.items():
        write_tester_dumps(config_for_tester(small, name, **kw), base)
    return out


def card_step(rank, world, cfg, pairs, states, device="cuda"):
    """One distributed train step on this rank's card (in the group that
    `spawn` or the caller made), pair `rank` drawing its Gumbel noise from
    states[rank]; then six all-reduces alone of a buffer of the flat
    gradient's size. Returns the step's metrics, timings and kernel
    launches, digests of the reduced gradient and of the parameters after
    the step (rank 0 also the arrays), and the all-reduces' ms but the
    first."""
    from roitr_torch import kernels
    from roitr_torch.parallel.distributed import all_reduce_weighted_
    from roitr_torch.parallel.train_step import STEP_METRICS

    dev = init_distributed(cfg, device)
    model = RoITr(cfg, device=dev, seed=0)
    broadcast_parameters(model)
    opt = make_optimizer(cfg, model, steps_per_epoch=1)
    grads = capture_grads(opt)
    timings = {}
    kernels.reset_launch_counts()
    metrics = train_step(model, opt, dict_to_pair(pairs[rank], dev), generator(states[rank]),
                         timings)
    launches = dict(kernels.launch_counts)
    flat = flat_params(model)
    buf = torch.zeros(flat.size + len(STEP_METRICS), device=dev)
    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_weighted_(buf, 1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(metrics=metrics, timings=timings, launches=launches,
                grad=grads[0] if rank == 0 else None, grad_digest=digest(grads[0]),
                flat=flat if rank == 0 else None, flat_digest=digest(flat),
                allreduce_ms=ms[1:], mb=buf.numel() * 4 / 1e6)
