"""Masked k-nearest-neighbor search, gathering and 3-NN interpolation.

Counterpart of roitr_tpu/ops/neighbors.py. Distances come in query tiles,
so the (Q, N) matrix never exists whole: at the 32768 bucket it would be
4 GB. The search is exact. The JAX package's `method="approx"` is
`jax.lax.approx_min_k`, a TPU operator that XLA computes exactly on every
other backend (recall 1.0); the port takes that meaning
(`check_knn_method`).
"""

from __future__ import annotations

import functools
import logging

import torch

from roitr_torch.ops.geometry import pairwise_sq_dist, prefix_mask
from roitr_torch.ops.topk import topk
from roitr_torch.utils.profiling import span

_INF = 1e10
# distance entries per query tile (fp32 distances + int64 sort keys)
_TILE_ELEMS = 1 << 25

KNN_METHODS = ("exact", "approx")


def check_knn_method(method: str) -> None:
    """Accept the config's `knn_method`: "exact", or "approx", which runs
    the same exact search (logged once); raise for anything else."""
    if method not in KNN_METHODS:
        raise ValueError(f"knn_method must be one of {KNN_METHODS}, got {method!r}")
    if method == "approx":
        _note_approx()


@functools.cache
def _note_approx() -> None:
    logging.getLogger("roitr_torch").info(
        "knn_method 'approx': the port runs the exact kNN, recall 1.0, as XLA computes "
        "approx_min_k off the TPU")


def masked_knn(queries: torch.Tensor, keys: torch.Tensor, key_count, k: int,
               exclude_self: bool = False):
    """k nearest valid keys for each query.

    queries (Q, 3), keys (N, 3) with `key_count` valid prefix rows ->
    (idx (Q, k) int64, dist (Q, k) sqrt-distances), ascending, ties to the
    lower index. With a leading batch axis, queries (B, Q, 3), keys
    (B, N, 3) and key_count (B,), each cloud's queries search its own keys
    (indices into that cloud). `exclude_self=True` takes k+1 and drops the
    nearest, and keeps the reference kernel's short-segment padding: when a
    cloud has fewer than k+1 valid points, the trailing slots are point 0 at
    the sentinel distance, and they take part in attention like any
    neighbor (reference knnquery_cuda_kernel.cu:65-108).
    """
    with span("knn", keys.device):
        q, n = queries.shape[-2], keys.shape[-2]
        batch = queries.shape[:-2]
        kk = min(k + 1 if exclude_self else k, n)
        count = torch.as_tensor(key_count, device=keys.device)
        key_invalid = torch.arange(n, device=keys.device) >= count[..., None]  # (..., N)
        inf = torch.tensor(_INF, dtype=torch.float32, device=keys.device)
        tile = max(1, _TILE_ELEMS // max(n * batch.numel(), 1))
        idx_parts, d2_parts = [], []
        for s in range(0, q, tile):
            d2 = pairwise_sq_dist(queries[..., s:s + tile, :], keys)
            d2 = torch.where(key_invalid[..., None, :], inf, d2)
            d, i = topk(d2, kk, dim=-1, largest=False)
            idx_parts.append(i)
            d2_parts.append(d)
        idx = torch.cat(idx_parts, dim=-2)
        d2 = torch.cat(d2_parts, dim=-2)
        if exclude_self:
            idx, d2 = idx[..., 1:], d2[..., 1:]
            if idx.shape[-1] < k:
                pad = (*batch, q, k - idx.shape[-1])
                idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
                d2 = torch.cat([d2, d2.new_full(pad, _INF)], dim=-1)
            rank = torch.arange(idx.shape[-1], device=idx.device)
            phantom = rank >= count[..., None, None] - 1
            idx = torch.where(phantom, torch.zeros_like(idx), idx)
            d2 = torch.where(phantom, inf, d2)
        return idx, torch.sqrt(d2)


def masked_min_dist(queries: torch.Tensor, keys: torch.Tensor, key_count) -> torch.Tensor:
    """1-NN distance (no index) from each query to the valid keys: queries
    (Q, 3), keys (N, 3) with `key_count` valid prefix rows -> (Q,) sqrt
    distances. A min-reduce over query tiles of per-coordinate differences
    (no x^2 - 2xy + y^2 cancellation), as in the JAX package; the (Q, N)
    matrix never exists whole."""
    with span("knn", keys.device):
        q, n = queries.shape[0], keys.shape[0]
        key_invalid = ~prefix_mask(n, key_count, device=keys.device)
        inf = torch.tensor(_INF, dtype=torch.float32, device=keys.device)
        tile = max(1, _TILE_ELEMS // 4 // max(n, 1))
        parts = []
        for s in range(0, q, tile):
            t = queries[s:s + tile]
            d2 = sum((t[:, i, None] - keys[None, :, i]) ** 2 for i in range(3))  # (T, N)
            parts.append(torch.where(key_invalid[None, :], inf, d2).amin(dim=1))
        return torch.sqrt(torch.cat(parts))


def knn_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of data (N, C) by idx (..., K) -> (..., K, C)."""
    return data[idx]


def three_nn_interpolate(parent_xyz, child_xyz, child_feats, child_count, k: int = 3,
                         idx=None, weight=None):
    """Inverse-distance weighted k-NN upsampling child -> parent
    (reference pointops.interpolation, functions/pointops.py:168-182).
    `idx` / `weight` take precomputed values (data/pyramid.py)."""
    if idx is None or weight is None:
        idx, dist = masked_knn(parent_xyz, child_xyz, child_count, k)
        recip = 1.0 / torch.clamp(dist, min=1e-8)
        weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    feats = knn_gather(child_feats, idx)  # (N, k, C)
    return torch.sum(feats * weight[..., None], dim=1)
