"""Data parallelism over processes, one card each.

Counterpart of roitr_tpu/parallel/mesh.py. JAX runs one program over a 1-D
`data` mesh and lets XLA reduce the gradients; the port runs one process a
card in a `torch.distributed` process group (NCCL on cards, gloo on the
CPU), as the reference's DDP does (main.py:27-34), and reduces explicitly:
each train step sums one flat buffer (every gradient and the step's
metrics, each rank's weighted by its pairs) in one all-reduce
(`all_reduce_weighted_`, parallel/train_step.py).

    torchrun --nproc_per_node=4 train.py    # one rank a card

`init_distributed` joins the group that torchrun's environment describes
(or finds one already made, as `spawn` makes it). `spawn` starts a group
of processes on one host through a file store and gathers what each rank
returns; the tests and chip_smoke.py use it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
TIMEOUT_S = 600.0


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def local_world() -> int:
    """Ranks on this host (torchrun's LOCAL_WORLD_SIZE; `spawn` starts every
    rank on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world()))


def init_distributed(cfg, device, backend: Optional[str] = None) -> torch.device:
    """Join the data-parallel process group; returns this rank's device.

    - A group already made (by `spawn`, or by the caller) is used as it is.
    - Else, under torchrun (RANK, WORLD_SIZE, LOCAL_RANK in the
      environment), the card LOCAL_RANK is made current before anything is
      allocated on it, and the group is made with `backend` (NCCL on cards,
      gloo on the CPU by default) and a timeout, so that a rank waiting for
      one that died fails.
    - Else the run is one process: `cfg.dp_size` > 1 then raises, with the
      torchrun command that would run it.

    `cfg.dp_size` None means the world size; any other value must equal it."""
    device = torch.device(device)
    dp = None if cfg.dp_size is None else int(cfg.dp_size)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        if device.type == "cuda":
            torch.cuda.set_device(local_rank)
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if not dist.is_initialized():
        if dp is not None and dp > 1:
            raise RuntimeError(
                f"dp_size={dp} needs one process a card in a process group, and there is none: "
                f"launch with `torchrun --nproc_per_node={dp} <script>` (one rank a card)")
        return device
    if dp is not None and dp != world():
        raise ValueError(f"dp_size={dp} but the process group has {world()} ranks")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _device_ids() -> Optional[List[int]]:
    if dist.get_backend() == "nccl":
        return [torch.cuda.current_device()]
    return None


def barrier() -> None:
    """Wait for every rank (nothing in one process)."""
    if dist.is_initialized():
        dist.barrier(device_ids=_device_ids())


@torch.no_grad()
def broadcast_parameters(model: torch.nn.Module) -> None:
    """Every parameter and buffer from rank 0, in place."""
    for t in model.state_dict().values():
        dist.broadcast(t, src=0)


def ranks_with(flag: bool, device) -> int:
    """How many ranks hold `flag` (an all-reduce of one number)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t)
    return int(t.item())


def lockstep(batches: Iterable, device) -> Iterator:
    """This rank's batches, then None once it has run out, for as long as
    any rank has one: every rank takes the same number of steps, so none
    waits in a collective that the others have left."""
    it = iter(batches)
    while True:
        batch = next(it, None)
        if not ranks_with(batch is not None, device):
            return
        yield batch


def all_reduce_weighted_(flat: torch.Tensor, n: int) -> int:
    """`flat` holds means over this rank's `n` pairs (n may be 0: zeros).
    Replace it, in place, by the means over every rank's pairs: the sum of
    flat * n over the ranks, divided by the sum of n, in one all-reduce of
    one buffer. Returns the sum of n."""
    buf = torch.empty(flat.numel() + 1, dtype=flat.dtype, device=flat.device)
    torch.mul(flat, n, out=buf[:-1])
    buf[-1] = n
    dist.all_reduce(buf)
    total = buf[-1:].clamp(min=1)
    torch.div(buf[:-1], total, out=flat)
    return int(buf[-1].item())


def reduce_metrics(meters, keys: Sequence[str], device) -> Dict[str, float]:
    """The pair-weighted averages of `keys` over every rank's MetricMeters
    (utils/logging.py), the same on every rank: each key's (sum, count),
    fp64 on `device`, summed over the ranks in one all-reduce. A rank with
    no pairs adds zeros."""
    if world() == 1:
        return meters.averages()
    buf = torch.tensor([[meters.meters[k].sum, meters.meters[k].count] if k in meters.meters
                        else [0.0, 0.0] for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(buf)
    return {k: float(s) / max(float(c), 1.0) for k, (s, c) in zip(keys, buf.tolist())}


def _child(fn, rank_: int, world_: int, backend: str, store: str, device: str, args, results,
           timeout_s: float) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank_,
                                world_size=world_, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            value = fn(rank_, world_, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank_, True, value))
    except Exception:  # reported to the parent, which fails the whole group
        results.put((rank_, False, traceback.format_exc()))


def spawn(fn: Callable, world_: int, backend: str, args: Sequence = (),
          devices: Optional[Sequence[str]] = None, timeout_s: float = 300.0) -> List[Any]:
    """Run fn(rank, world, *args) in `world_` new processes joined in a
    process group (`backend`, a file store in a temporary directory: no
    port), rank r on devices[r] (default the CPU); returns each rank's
    result, in rank order. `fn` must be importable by name and import no
    more than it needs (each rank starts a fresh interpreter). Raises if a
    rank raises or dies, or if the group is not done within `timeout_s`
    seconds; every process is ended before it returns."""
    devices = list(devices or ["cpu"] * world_)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_child, args=(fn, r, world_, backend,
                                                  os.path.join(tmp, "store"), devices[r], args,
                                                  results, timeout_s), daemon=True)
                 for r in range(world_)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        out: Dict[int, Any] = {}
        try:
            while len(out) < world_:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world_)) - set(out))} not done "
                                       f"within {timeout_s:.0f} s")
                try:
                    r, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} died without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {world_} failed:\n{value}")
                out[r] = value
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == world_ else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world_)]
