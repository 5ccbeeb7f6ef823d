"""Pairs from a dataset, one at a time (host side).

Counterpart of roitr_tpu/data/loader.py for batch 1 in one process: the
same shuffled order (`np.random.RandomState(seed).shuffle`) and
`max_items` cut, each preprocessed item turned into a PairInputs on the
device. Packed batches are data/packing.py's; the BucketBatcher (stacked
and packed training batches), worker processes and per-host sharding are
later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from roitr_torch.data.pyramid import pyramid_to_torch
from roitr_torch.models.roitr import PairInputs
from roitr_torch.utils.packing import to_device


def dict_to_pair(d: Dict[str, np.ndarray], device="cpu") -> PairInputs:
    """A preprocessed item (numpy dict of one padded pair) -> PairInputs,
    with its host pyramids, if it has them, on `device`: all of it in one
    copy from one pinned buffer (utils/packing.py)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    count = lambda c: torch.tensor(int(c), dtype=torch.int64)
    pyr = lambda p: None if p is None else pyramid_to_torch(p)
    return to_device(PairInputs(
        src_points=t(d["src_points"]), src_raw_points=t(d["src_raw_points"]),
        src_normals=t(d["src_normals"]), src_feats=t(d["src_feats"]),
        src_count=count(d["src_count"]), tgt_points=t(d["tgt_points"]),
        tgt_normals=t(d["tgt_normals"]), tgt_feats=t(d["tgt_feats"]),
        tgt_count=count(d["tgt_count"]), rot=t(d["rot"]), trans=t(d["trans"]),
        src_pyramid=pyr(d.get("src_pyramid")), tgt_pyramid=pyr(d.get("tgt_pyramid"))), device)


def iterate_batches(dataset, shuffle: bool = False, seed: int = 0,
                    max_items: Optional[int] = None, device="cpu") -> Iterator[PairInputs]:
    """Yield one PairInputs a dataset item, in the JAX loader's order."""
    indices = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(indices)
    if max_items is not None:
        indices = indices[:max_items]
    for i in indices:
        yield dict_to_pair(dataset[int(i)], device)
