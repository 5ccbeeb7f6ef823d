"""Test-split inference with dumps the registration evaluators read.

Counterpart of roitr_tpu/eval/tester.py (reference lib/tester.py:11-88),
one pair a step on one card: each test pair goes through the forward with
its GT analysis (`with_gt=True`), and one file a pair is dumped with the
key set the unchanged `registration/` evaluators read (reference
tester.py:56-68). The forward's fixed-capacity buffers are trimmed to their
valid counts on the host, which gives back the reference's ragged shapes.
Dumps are torch `.pth` files with the JAX package's keys and dtypes.

    tester = Tester(cfg)            # device="cuda"; cfg.pretrain, test split
    tester.test()                   # snapshot/<exp_dir>/<benchmark>/<i>.pth

With `cfg.packed_batch` and `cfg.batch_size` B > 1, B same-bucket pairs
go through one packed forward (data/packing.py) and are dumped one file a
pair, as the single-pair loop dumps them. With `cfg.num_workers` > 1
the pairs are prepared in that many worker subprocesses
(data/worker_pool.py, at most one a core, the host's ranks sharing its
cores), in order, while the card runs the forwards. Across several cards
(`dp_size` > 1 under torchrun, one process a card:
parallel/distributed.py) rank r of W runs the pairs r, r + W, ... and
writes their dumps under their indices in the split, as JAX's Tester
shards the pair stream over its `data` mesh.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.loader import dict_to_pair
from roitr_torch.data.packing import pack_pairs
from roitr_torch.data.worker_pool import WorkerPool
from roitr_torch.models.roitr import RoITr, resolve_device
from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair
from roitr_torch.parallel.distributed import barrier, init_distributed, local_world, rank, world
from roitr_torch.train.checkpoint import load_model_state
from roitr_torch.train.trainer import Trainer
from roitr_torch.utils.packing import to_device

# the forward-output keys that dump_mode="full" reads (trim_outputs)
DUMP_KEYS = (
    "src_count", "tgt_count", "src_node_count", "tgt_node_count",
    "corr_masks", "src_points", "tgt_points", "src_nodes", "tgt_nodes",
    "src_node_feats", "tgt_node_feats", "src_point_feats", "tgt_point_feats",
    "src_corr_points", "tgt_corr_points", "corr_scores",
    "gt_tgt_node_occ", "gt_src_node_occ",
)

# dump_mode="c2f": only what the registration evaluators use. The
# reference's registration/evaluate_registration_c2f.py:69-75 loads the
# descriptors and never uses them; they are left out and the correspondence
# buffers compacted (compact_corr)
C2F_KEYS = (
    "src_count", "tgt_count", "src_node_count", "tgt_node_count",
    "src_points", "tgt_points", "src_nodes", "tgt_nodes",
    "corr_count", "corr_total",
    "src_corr_points", "tgt_corr_points", "corr_scores",
    "gt_tgt_node_occ", "gt_src_node_occ",
)
# keys the reference evaluator loads but never uses: empty in c2f dumps, so
# the unchanged script still runs
C2F_PLACEHOLDERS = ("src_node_desc", "tgt_node_desc", "src_point_desc", "tgt_point_desc")


def compact_corr(out: Dict[str, torch.Tensor], cap: int) -> Dict[str, torch.Tensor]:
    """Move the valid entries of the correspondence buffers to the front in
    their original order (a stable argsort of the inverted mask), keeping at
    most `cap`. Whenever the valid count fits `cap`, the trimmed dump equals
    dump_mode="full"'s. `corr_total` is the count before the cap,
    `corr_count` after it. The result has no `corr_masks`: the mask of the
    original order would select the wrong rows of the compacted arrays."""
    masks = out["corr_masks"]
    if masks.ndim == 2:  # a packed batch: each pair compacted alone
        per_pair = [compact_corr({key: out[key][i] for key in _CORR_KEYS}, cap)
                    for i in range(masks.shape[0])]
        res = {key: v for key, v in out.items() if key not in _CORR_KEYS}
        res.update({key: torch.stack([r[key] for r in per_pair]) for key in per_pair[0]})
        return res
    k = min(cap, masks.shape[0])
    order = torch.argsort((~masks).to(torch.int32), stable=True)[:k]
    total = masks.sum()
    res = {key: v for key, v in out.items() if key != "corr_masks"}
    res.update(src_corr_points=out["src_corr_points"][order],
               tgt_corr_points=out["tgt_corr_points"][order],
               corr_scores=out["corr_scores"][order],
               corr_total=total, corr_count=torch.clamp(total, max=k))
    return res


_CORR_KEYS = ("corr_masks", "src_corr_points", "tgt_corr_points", "corr_scores")


def _queue_fetch(out: Dict[str, torch.Tensor], keys):
    """Queue the copies of the dump's subset into pinned host tensors on the
    current stream, without waiting: (host tensors, event after the copies,
    or None when nothing is on the card). A `.cpu()` on another thread would
    run on the same stream and wait for every launch queued before it,
    the next pair's forward included."""
    host = {}
    for k in keys:
        v = out[k].detach()
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v = h
        host[k] = v
    event = None
    if any(out[k].is_cuda for k in keys):
        event = torch.cuda.Event()
        event.record()
    return host, event


def _finish_fetch(host: Dict[str, torch.Tensor], event) -> Dict[str, np.ndarray]:
    """Wait for the copies of _queue_fetch (only them) -> numpy arrays."""
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def fetch_outputs(out: Dict[str, torch.Tensor], keys=DUMP_KEYS) -> Dict[str, np.ndarray]:
    """The dump's subset of the forward's outputs as numpy arrays."""
    return _finish_fetch(*_queue_fetch(out, keys))


def trim_outputs(out: Dict[str, np.ndarray], pair, metric_index=None) -> Dict[str, np.ndarray]:
    """Slice the fixed-capacity buffers to their valid entries (host side).
    `pair` is the host PairInputs (raw source points and GT transform)."""
    sc, tc = int(out["src_count"]), int(out["tgt_count"])
    snc, tnc = int(out["src_node_count"]), int(out["tgt_node_count"])
    data = {
        "src_raw_pcd": np.asarray(pair.src_raw_points)[:sc],
        "src_pcd": np.asarray(out["src_points"])[:sc],
        "tgt_pcd": np.asarray(out["tgt_points"])[:tc],
        "src_nodes": np.asarray(out["src_nodes"])[:snc],
        "tgt_nodes": np.asarray(out["tgt_nodes"])[:tnc],
    }
    if "corr_count" in out:  # dump_mode="c2f": compact_corr ran
        cc, total = int(out["corr_count"]), int(out["corr_total"])
        if total > cc:
            warnings.warn(f"dump_mode='c2f': {total} valid correspondences truncated to "
                          f"dump_corr_cap={cc}; raise cfg.dump_corr_cap")
        keep = slice(0, cc)
        for k in C2F_PLACEHOLDERS:
            data[k] = np.zeros((0,), np.float32)
    else:
        keep = np.asarray(out["corr_masks"])
        data.update(
            src_node_desc=np.asarray(out["src_node_feats"])[:snc],
            tgt_node_desc=np.asarray(out["tgt_node_feats"])[:tnc],
            src_point_desc=np.asarray(out["src_point_feats"])[:sc],
            tgt_point_desc=np.asarray(out["tgt_point_feats"])[:tc])
    data.update(
        src_corr_pts=np.asarray(out["src_corr_points"])[keep],
        tgt_corr_pts=np.asarray(out["tgt_corr_points"])[keep],
        confidence=np.asarray(out["corr_scores"])[keep],
        gt_tgt_node_occ=np.asarray(out["gt_tgt_node_occ"])[:tnc],
        gt_src_node_occ=np.asarray(out["gt_src_node_occ"])[:snc],
        rot=np.asarray(pair.rot), trans=np.asarray(pair.trans))
    if metric_index is not None:
        data["metric_index_list"] = np.asarray(metric_index)
    return data


def dump_pair(path_base: str, data: Dict[str, np.ndarray]) -> None:
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in data.items()},
               path_base + ".pth")


def load_dump(path: str) -> Dict[str, np.ndarray]:
    """One dump (`.pth` as dump_pair writes it, or `.npz`) as numpy arrays."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in data.items()}


def list_dumps(desc_dir: str) -> List[str]:
    """The `<i>.pth` / `<i>.npz` dumps of a directory, by pair index."""
    files = glob.glob(os.path.join(desc_dir, "*.pth")) + glob.glob(
        os.path.join(desc_dir, "*.npz"))
    return sorted(files, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))


class Tester:
    """Test-split inference loop writing one dump a pair (reference
    lib/tester.py:19-69). `state_dict` overrides `cfg.pretrain` (a port
    checkpoint, train/checkpoint.py, a reference RoITr `.pth` or a bare
    state_dict: `load_model_state`). With
    `cfg.device_prep` the dataset ships zero normals and they are estimated
    on the device before the forward. With `cfg.packed_batch`, batches of
    `cfg.batch_size` same-bucket pairs run as one packed forward; that needs
    host pyramids (`cfg.host_pyramid`) or device prep, which builds them.
    In a process group each rank runs its stride of the split (and packs
    only its own pairs); `test` returns once every rank has written its
    dumps."""

    def __init__(self, cfg: Config, dataset=None, state_dict=None, device="cuda"):
        self.pack = max(int(cfg.batch_size or 1), 1) if cfg.packed_batch else 1
        if self.pack > 1 and not (cfg.host_pyramid or cfg.device_prep):
            raise ValueError("packed_batch requires host_pyramid or device_prep")
        if cfg.dump_mode not in ("full", "c2f"):
            raise ValueError(f"dump_mode must be 'full' or 'c2f', got {cfg.dump_mode!r}")
        self.cfg = cfg
        self.device = init_distributed(cfg, resolve_device(device))
        self.rank, self.world = rank(), world()
        self.fetch_keys = DUMP_KEYS if cfg.dump_mode == "full" else C2F_KEYS
        self.snapshot_dir = os.path.join("snapshot", cfg.exp_dir, cfg.benchmark)
        os.makedirs(self.snapshot_dir, exist_ok=True)
        self.dataset = dataset if dataset is not None else get_dataset(cfg, "test")
        if state_dict is None:
            if not cfg.pretrain:
                raise ValueError("Tester needs cfg.pretrain or an explicit state_dict")
            state_dict = load_model_state(cfg.pretrain)
        self.model = RoITr(cfg, device=self.device)
        self.model.load_state_dict(state_dict)
        self.model.eval()

    def _forward(self, pair) -> Dict[str, torch.Tensor]:
        """One pair, or a packed batch (counts of shape (B,))."""
        if self.cfg.device_prep:
            prep = device_prep_packed if pair.src_count.ndim else device_prep_pair
            pair = prep(pair, self.cfg)
        out = self.model(pair, with_gt=True)
        if self.cfg.dump_mode == "c2f":
            out = compact_corr(out, self.cfg.dump_corr_cap)
        return out

    def _dump(self, idx: int, item: Dict, out: Dict[str, np.ndarray]) -> None:
        data = trim_outputs(out, dict_to_pair(item), metric_index=item.get("metric_index"))
        dump_pair(os.path.join(self.snapshot_dir, str(idx)), data)

    def _items(self, indices: List[int]):
        """(pool or None, the dataset's items at `indices`, in order): from
        min(cfg.num_workers, cores // ranks on the host) worker subprocesses
        when that is more than one and there is more than one pair (JAX's
        Tester._items), else read here."""
        workers = min(int(self.cfg.num_workers), (os.cpu_count() or 1) // local_world())
        if workers > 1 and len(indices) > 1:
            pool = WorkerPool(self.dataset, workers)
            return pool, pool.imap(indices)
        return None, (self.dataset[i] for i in indices)

    def _groups(self, indices: List[int], items):
        """(entries, PairInputs on the device) a forward: one pair each, or
        with packing up to `self.pack` same-bucket pairs packed (a bucket's
        ragged tail as a smaller batch). entries: (index, item, slot in the
        batch or None)."""
        if self.pack == 1:
            for idx, item in zip(indices, items):
                yield [(idx, item, None)], dict_to_pair(item, self.device)
            return
        pending: Dict[int, list] = {}

        def packed(group):
            pairs = [dict_to_pair(item) for _, item in group]
            batch = pack_pairs(pairs, require_pyramids=not self.cfg.device_prep)
            return ([(idx, item, i) for i, (idx, item) in enumerate(group)],
                    to_device(batch, self.device))

        for idx, item in zip(indices, items):
            bucket = int(item["src_points"].shape[0])
            pending.setdefault(bucket, []).append((idx, item))
            if len(pending[bucket]) == self.pack:
                yield packed(pending.pop(bucket))
        for group in pending.values():
            yield packed(group)

    @torch.no_grad()
    def test(self) -> None:
        """The inference loop. The main thread prepares each pair (or packed
        batch), queues its forward and the copies of its outputs; one worker
        thread waits for those copies, trims and writes the dumps, so the
        next forward's host prep and forward overlap it. The queue holds at
        most two forwards' outputs. In a process group this rank runs its
        stride of the pairs, then waits for the others."""
        indices = list(range(self.rank, len(self.dataset), self.world))
        n = len(indices)
        t0 = time.perf_counter()
        jobs: queue.Queue = queue.Queue(maxsize=2)
        errors: list = []

        def worker():
            while True:
                job = jobs.get()
                if job is None:
                    return
                entries, host, event = job
                try:
                    fetched = _finish_fetch(host, event)
                    for idx, item, i in entries:
                        self._dump(idx, item, fetched if i is None
                                   else {k: v[i] for k, v in fetched.items()})
                except Exception as e:  # re-raised on the main thread
                    errors.append(e)

        pool, items = self._items(indices)
        thread = threading.Thread(target=worker, name="roitr-tester-dump", daemon=True)
        thread.start()
        try:
            for entries, pair in self._groups(indices, items):
                if errors:
                    break
                out = self._forward(pair)
                jobs.put((entries, *_queue_fetch(out, self.fetch_keys)))
        finally:
            # the worker writes every dump queued before the sentinel, then ends
            jobs.put(None)
            thread.join()
            if pool is not None:
                pool.close()
        if errors:
            raise errors[0]
        if n:
            wall = time.perf_counter() - t0
            where = f" on rank {self.rank} of {self.world}" if self.world > 1 else ""
            print(f"tested {n} pairs{where}, {wall / n:.3f}s/pair (wall incl. host prep and "
                  "dumps)")
        barrier()


def get_trainer(cfg: Config, device="cuda"):
    """Mode dispatch (reference lib/tester.py:78-88)."""
    if cfg.mode in ("train", "val"):
        return Trainer(cfg, device=device)
    return Tester(cfg, device=device)
