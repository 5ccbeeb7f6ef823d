"""Bucketed batches from a dataset, prefetched on a host thread.

Counterpart of roitr_tpu/data/loader.py in one process: the same shuffled
order (`np.random.RandomState(seed).shuffle`) and `max_items` cut, pairs
grouped by bucket into batches of `batch_size` (`BucketBatcher`), and a
background thread that prepares the next batches while the card runs the
current one. A batch is one PairInputs (batch_size 1), a list of
batch_size single pairs, or, with `pack`, packed pairs
(data/packing.py `pack_pairs`): each batch reaches the device in one copy
from one pinned buffer (utils/packing.py).

Unlike JAX's, a bucket's ragged tail is emitted as a smaller batch, never
filled by repeating its last pair: an eager step has no compiled program
per batch size to reuse, and a repeated pair would weigh twice in that
step's mean gradient. With `num_workers` > 0 the items are prepared in
that many worker subprocesses (data/worker_pool.py), in the same order.
Under data parallelism each process takes its stride of the shuffled
order (`process_index`, `process_count`), as JAX's does.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from roitr_torch.data.packing import pack_pairs
from roitr_torch.data.pyramid import pyramid_to_torch
from roitr_torch.data.worker_pool import WorkerPool
from roitr_torch.models.roitr import PairInputs
from roitr_torch.utils.packing import to_device
from roitr_torch.utils.profiling import span

Batch = Union[PairInputs, List[PairInputs]]


def _host_pair(d: Dict[str, np.ndarray]) -> PairInputs:
    """A preprocessed item (numpy dict of one padded pair) -> PairInputs of
    CPU tensors, with its host pyramids if it has them."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    count = lambda c: torch.tensor(int(c), dtype=torch.int64)  # noqa: E731
    pyr = lambda p: None if p is None else pyramid_to_torch(p)  # noqa: E731
    return PairInputs(
        src_points=t(d["src_points"]), src_raw_points=t(d["src_raw_points"]),
        src_normals=t(d["src_normals"]), src_feats=t(d["src_feats"]),
        src_count=count(d["src_count"]), tgt_points=t(d["tgt_points"]),
        tgt_normals=t(d["tgt_normals"]), tgt_feats=t(d["tgt_feats"]),
        tgt_count=count(d["tgt_count"]), rot=t(d["rot"]), trans=t(d["trans"]),
        src_pyramid=pyr(d.get("src_pyramid")), tgt_pyramid=pyr(d.get("tgt_pyramid")))


def dict_to_pair(d: Dict[str, np.ndarray], device="cpu") -> PairInputs:
    """A preprocessed item (numpy dict of one padded pair) -> PairInputs,
    with its host pyramids, if it has them, on `device`: all of it in one
    copy from one pinned buffer (utils/packing.py)."""
    return to_device(_host_pair(d), device)


class BucketBatcher:
    """Groups same-bucket pairs into batches of `batch_size` (JAX's
    BucketBatcher). A batch of one is the pair itself; of more, a list of
    the pairs in arrival order, or with pack > 1 the packed pairs
    (pack_pairs) of every `pack` consecutive ones: one packed pair when
    pack == batch_size, the loader's case. `flush` emits each bucket's
    remainder as a smaller batch of the pairs left, each once."""

    def __init__(self, batch_size: int, pack: int = 0):
        if pack and batch_size % pack != 0:
            raise ValueError(f"batch_size {batch_size} not a multiple of pack {pack}")
        self.batch_size = batch_size
        self.pack = pack
        self._pending: Dict[int, List[PairInputs]] = {}

    def _emit(self, pend: List[PairInputs]) -> Batch:
        if self.pack > 1:
            packed = [pack_pairs(pend[i:i + self.pack]) for i in range(0, len(pend), self.pack)]
            return packed[0] if len(packed) == 1 else packed
        return pend[0] if len(pend) == 1 else pend

    def add(self, pair: PairInputs) -> Optional[Batch]:
        bucket = int(pair.src_points.shape[0])
        pend = self._pending.setdefault(bucket, [])
        pend.append(pair)
        if len(pend) == self.batch_size:
            self._pending[bucket] = []
            return self._emit(pend)
        return None

    def flush(self) -> List[Batch]:
        out = [self._emit(pend) for pend in self._pending.values() if pend]
        self._pending = {}
        return out


def iterate_batches(dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                    max_items: Optional[int] = None, prefetch: int = 2, pack: int = 0,
                    device="cpu", num_workers: int = 0, process_index: int = 0,
                    process_count: int = 1) -> Iterator[Batch]:
    """Yield batches of the dataset's items on `device`, in the JAX
    loader's order, prepared up to `prefetch` batches ahead on one
    background thread (packing and the host-to-device copy, and the dataset
    reads, or with num_workers > 0 the reads of a WorkerPool's items).
    batch_size 1 yields one PairInputs an item; pack > 1 packs every
    `pack` pairs of a batch (see BucketBatcher). After the shuffle this
    process keeps the indices `process_index::process_count`, then the
    first `max_items` of them (JAX's order). The pool is closed when the
    iteration ends, fails or is abandoned."""
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    indices = [int(i) for i in indices[process_index::process_count][:max_items]]
    pool = WorkerPool(dataset, num_workers) if num_workers > 0 and indices else None
    items = pool.imap(indices) if pool is not None else (dataset[i] for i in indices)

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        batcher = BucketBatcher(batch_size, pack=pack)
        try:
            for item in items:
                if stop.is_set():
                    return
                batch = batcher.add(_host_pair(item))
                if batch is not None and not put(to_device(batch, device)):
                    return
            for batch in batcher.flush():
                if not put(to_device(batch, device)):
                    return
        except BaseException as e:  # handed to the consumer, raised there
            put(e)
        finally:
            put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with span("loader.wait", device=False):
                item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
        if pool is not None:
            pool.close()
