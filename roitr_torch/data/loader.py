"""Pairs from a dataset, one at a time (host side).

Counterpart of roitr_tpu/data/loader.py for batch 1 in one process: the
same shuffled order (`np.random.RandomState(seed).shuffle`) and
`max_items` cut, each preprocessed item turned into a PairInputs on the
device. Stacked and packed batches, worker processes and per-host sharding
are later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from roitr_torch.models.roitr import PairInputs


def dict_to_pair(d: Dict[str, np.ndarray], device="cpu") -> PairInputs:
    """A preprocessed item (numpy dict of one padded pair) -> PairInputs."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    count = lambda c: torch.tensor(int(c), dtype=torch.int64, device=device)
    return PairInputs(
        src_points=t(d["src_points"]), src_raw_points=t(d["src_raw_points"]),
        src_normals=t(d["src_normals"]), src_feats=t(d["src_feats"]),
        src_count=count(d["src_count"]), tgt_points=t(d["tgt_points"]),
        tgt_normals=t(d["tgt_normals"]), tgt_feats=t(d["tgt_feats"]),
        tgt_count=count(d["tgt_count"]), rot=t(d["rot"]), trans=t(d["trans"]))


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
