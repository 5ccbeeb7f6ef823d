"""The inputs a run sends, made from its seed: the same for the program and
for the reference, whichever process makes them.

- `request_pool`: raw (src, tgt) XYZ clouds of the serving traffic;
- `train_items`: padded training pairs with normals, counts and the
  ground-truth motion (rigid surface pairs or non-rigid flow pairs), with
  the normals from the function given (the program's or the reference's);
- `epoch_order`: the loader's shuffle of the training pool, an epoch;
- the streams of one seed: 1 the pool, 2 the serving order, 3 the sample
  the reference checks; 100 + e the training order of epoch e.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

from portbench import synthetic

POOL, ORDER, SAMPLE = 1, 2, 3


def seed32(seed: int, stream: int) -> int:
    """A 32-bit seed for one stream of a run, for APIs that take one."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1)[0])


def request_pool(seed: int, traffic: Mapping) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = synthetic.rng_for(seed, POOL)
    lo, hi = traffic["points"]
    return [synthetic.surface_pair(rng, ns, nt, traffic["overlap"])[:2]
            for ns, nt in synthetic.count_pairs(lo, hi, traffic["pool"])]


def pick_bucket(n: int, buckets) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return sorted(buckets)[-1]


def train_items(seed: int, traffic: Mapping, buckets,
                normals: Callable[[np.ndarray], np.ndarray],
                select=None) -> List[Dict[str, np.ndarray]]:
    """The training pool: each item one padded pair as a dataset yields it
    (points, raw source, normals of the raw source and the target, feature
    ones, counts, rot, trans). With `select`, only those items are made
    (None in the other places), from the same draws."""
    rng = synthetic.rng_for(seed, POOL)
    lo, hi = traffic["points"]
    items = []
    for j, (ns, nt) in enumerate(synthetic.count_pairs(lo, hi, traffic["pool"])):
        if traffic["pairs"] == "flow":
            raw, src, tgt, rot, trans = synthetic.flow_pair(rng, ns, nt, traffic["overlap"])
        else:
            src, tgt, rot, trans = synthetic.surface_pair(rng, ns, nt, traffic["overlap"])
            raw = src
        if select is not None and j not in select:
            items.append(None)
            continue
        bucket = pick_bucket(max(ns, nt), buckets)
        item = {"rot": rot, "trans": trans, "src_count": np.int32(ns), "tgt_count": np.int32(nt)}
        for name, pts in (("src_points", src), ("src_raw_points", raw), ("tgt_points", tgt)):
            arr = np.zeros((bucket, 3), np.float32)
            arr[:len(pts)] = pts
            item[name] = arr
        for side, pts in (("src", raw), ("tgt", tgt)):
            arr = np.zeros((bucket, 3), np.float32)
            arr[:len(pts)] = normals(pts)
            item[f"{side}_normals"] = arr
            item[f"{side}_feats"] = np.ones((bucket, 1), np.float32)
        items.append(item)
    return items


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The loader's order of an epoch (np.random.RandomState(s).shuffle)."""
    idx = np.arange(n)
    np.random.RandomState(seed32(seed, 100 + epoch)).shuffle(idx)
    return idx


def item_counts(items: List[Dict[str, np.ndarray]], order) -> List[Tuple[int, int]]:
    """The (source, target) valid point counts of the items in `order`."""
    return [(int(items[i]["src_count"]), int(items[i]["tgt_count"])) for i in order]


def check_sample(seed: int, served: List[int], pool: List, k: int) -> List[int]:
    """The served pool entries the reference checks: the one with the most
    points in its larger cloud, and k - 1 more drawn from the seed."""
    served = sorted(set(served))
    largest = max(served, key=lambda i: (max(len(pool[i][0]), len(pool[i][1])), -i))
    rest = [i for i in served if i != largest]
    rng = synthetic.rng_for(seed, SAMPLE)
    extra = rng.choice(rest, size=min(k - 1, len(rest)), replace=False).tolist() if rest else []
    return sorted([largest] + [int(i) for i in extra])
