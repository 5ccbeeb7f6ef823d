"""GeoTransformer's grid pyramid and radius neighbours, on the device.

The pyramid of a pair (GeoTransformer's `precompute_data_stack_mode`):
stage 1 is the input, stage s > 1 the barycentre of each occupied voxel of
stage s - 1 at voxel size voxel_size * 2^(s-1). Each stage holds both
clouds stacked, the reference (target) first, as upstream stacks them, so
that one tensor and one launch serve both. The searches of a stage, at
radius r_s = base_radius * voxel_size * 2^(s-1):

- neighbors[s]: stage s against itself, radius r_s, the nearest
  neighbor_limits[s] kept;
- subsampling[s]: stage s + 1 queries against stage s keys, radius r_s,
  limit neighbor_limits[s];
- upsampling[s]: stage s queries against stage s + 1 keys, radius 2 r_s,
  limit 1 (the decoder reads only the nearest). Stage 1's is not built:
  the decoder stops at stage 2, so nothing reads it.

A search keeps the nearest keys of the query's own cloud whose distance is
below the radius, ascending, ties to the lower index; empty slots hold the
shadow index (the stage's row count), whose row the readers append.
Indices point into the stacked stage. Searches run on the kNN kernel
(`ops/neighbors.py` `masked_knn`, both clouds in one launch) with the
radius cut applied to the returned distances.

Departures from upstream, which the benchmark's reference shares: voxel
keys are floor(p / voxel) per coordinate, and a stage's nodes are ordered
by their voxel key (z, then y, then x) where upstream's follow a hash
map's order; a barycentre is the mean of its points in fixed point
(multiples of 2^-32 m, exact int64 sums from one prefix sum over the
key-sorted points), rounded to fp32 once, so no order of additions can
move it by a rounding and flip a voxel of the next stage. Coordinates must
lie within +-1024 m. Building a stage reads its counts back to the host
once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from roitr_torch.ops.neighbors import masked_knn

# voxel coordinates are offset by 2^19 and packed 20 bits each, the cloud
# above them: keys of clouds within +-2^19 voxels of the origin
_COORD_BITS = 20
_OFFSET = 1 << (_COORD_BITS - 1)
# barycentres sum coordinates in units of 2^-32 m: 60k points of at most
# 2^10 m sum below 2^59
FIXED = 2.0 ** 32
MAX_COORD = 1024.0
# GeoTransformer's 3DMatch pyramid: the KPConv-FPN reads four stages
NUM_STAGES = 4
# kNN kernel launches of one pair's pyramid: a neighbour search a stage, a
# subsampling search a stage but the last, an upsampling search a stage but
# the first and the last
GRID_SEARCHES = NUM_STAGES + (NUM_STAGES - 1) + (NUM_STAGES - 2)


class GridPyramid(NamedTuple):
    """A pair's stages, each the two clouds stacked (reference first)."""

    points: List[torch.Tensor]  # (n_s, 3) fp32 a stage
    lengths: List[Tuple[int, int]]  # (reference, source) rows a stage
    neighbors: List[torch.Tensor]  # (n_s, limit_s) int64 into stage s
    subsampling: List[torch.Tensor]  # (n_{s+1}, limit_s) into stage s
    upsampling: List[torch.Tensor]  # (n_s, 1) into stage s + 1; [0] is None


def voxel_keys(points: torch.Tensor, voxel: float, cloud: torch.Tensor) -> torch.Tensor:
    """(N,) int64 keys ordering points by (cloud, z, y, x) voxel."""
    # a 0-dim divisor on the device: a true fp32 division (a Python scalar
    # becomes a reciprocal product on the card), made without a copy
    size = torch.full((), voxel, dtype=torch.float32, device=points.device)
    v = torch.floor(points / size)
    v = v.to(torch.int64) + _OFFSET
    return ((cloud << (3 * _COORD_BITS)) | (v[:, 2] << (2 * _COORD_BITS))
            | (v[:, 1] << _COORD_BITS) | v[:, 0])


def grid_subsample(points: torch.Tensor, lengths: Tuple[int, int],
                   voxel: float) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The barycentres of the occupied voxels of each cloud of a stacked
    stage, in key order, and their counts (one read to the host)."""
    n0, n1 = lengths
    dev = points.device
    cloud = (torch.arange(n0 + n1, device=dev) >= n0).to(torch.int64)
    keys, order = torch.sort(voxel_keys(points, voxel, cloud), stable=True)
    start = torch.ones_like(keys, dtype=torch.bool)
    start[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1  # voxel of each sorted point
    far = (points.abs().amax() >= MAX_COORD).to(torch.int64)
    voxels0, total, far = torch.stack([seg[n0 - 1] + 1, seg[-1] + 1, far]).tolist()
    if far:
        raise ValueError(f"grid_subsample: coordinates beyond +-{MAX_COORD:g} m")
    ends = torch.searchsorted(seg, torch.arange(total, device=dev), right=True)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    fixed = torch.round(points[order].to(torch.float64) * FIXED).to(torch.int64)
    csum = torch.cat([fixed.new_zeros((3, 1)), torch.cumsum(fixed.t().contiguous(), 1)], 1)
    sums = (csum[:, ends] - csum[:, starts]).t()  # exact
    bary = sums.to(torch.float64) / (ends - starts).to(torch.float64)[:, None] / FIXED
    return bary.to(torch.float32), (voxels0, total - voxels0)


def by_cloud(points: torch.Tensor, lengths: Tuple[int, int]) -> torch.Tensor:
    """A stacked stage as (2, max length, 3), zero rows past each length."""
    n0, n1 = lengths
    out = points.new_zeros((2, max(n0, n1), 3))
    out[0, :n0] = points[:n0]
    out[1, :n1] = points[n0:]
    return out


def radius_search(queries: torch.Tensor, q_lengths: Tuple[int, int], keys: torch.Tensor,
                  k_lengths: Tuple[int, int], radius: float, limit: int) -> torch.Tensor:
    """(n_q, limit) int64: each query's nearest keys of its own cloud below
    `radius`, ascending, as indices into the stacked keys; empty slots hold
    the shadow index, the stacked keys' row count. `queries` and `keys` are
    stages in `by_cloud`'s layout."""
    (q0, q1), (k0, k1) = q_lengths, k_lengths
    dev = keys.device
    # (k0, k1) and (0, k0) made on the device: no copy, so no stream sync
    first = torch.arange(2, device=dev)
    idx, dist = masked_knn(queries, keys, first * (k1 - k0) + k0, limit)
    shadow = k0 + k1
    idx = torch.where(dist < radius, idx + (first * k0)[:, None, None],
                      torch.full_like(idx, shadow))
    if idx.shape[-1] < limit:  # fewer keys than the limit
        idx = torch.cat([idx, idx.new_full((2, idx.shape[1], limit - idx.shape[-1]), shadow)],
                        dim=-1)
    return torch.cat([idx[0, :q0], idx[1, :q1]])


def stage_radius(cfg, s: int) -> float:
    """The search radius of stage s (0-based)."""
    return cfg.base_radius * cfg.voxel_size * 2 ** s


def build_grid_pyramid(points: torch.Tensor, lengths: Tuple[int, int], cfg) -> GridPyramid:
    """The pyramid and every search of a pair whose clouds are stacked in
    `points`, reference first, `lengths` rows each. Reads each stage's
    counts to the host once, three reads for four stages."""
    pts, lens = [points], [tuple(int(n) for n in lengths)]
    voxel = cfg.voxel_size
    for _ in range(1, NUM_STAGES):
        voxel *= 2
        p, n = grid_subsample(pts[-1], lens[-1], voxel)
        pts.append(p)
        lens.append(n)
    limits = tuple(cfg.neighbor_limits)
    padded = [by_cloud(p, n) for p, n in zip(pts, lens)]
    neighbors, subsampling, upsampling = [], [], [None]
    for s in range(NUM_STAGES):
        r = stage_radius(cfg, s)
        neighbors.append(radius_search(padded[s], lens[s], padded[s], lens[s], r, limits[s]))
        if s + 1 < NUM_STAGES:
            subsampling.append(radius_search(padded[s + 1], lens[s + 1], padded[s], lens[s], r,
                                             limits[s]))
            if s > 0:
                upsampling.append(radius_search(padded[s], lens[s], padded[s + 1], lens[s + 1],
                                                2 * r, 1))
    return GridPyramid(pts, lens, neighbors, subsampling, upsampling)

