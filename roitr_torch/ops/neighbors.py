"""Masked k-nearest-neighbor search, gathering and 3-NN interpolation.

Counterpart of roitr_tpu/ops/neighbors.py. The search is exact: on the
card one kernel (kernels/knn_kernel.py, csrc/knn.cu) that keeps each
query's k best in registers; on the CPU the kernel's plain version, which
computes distances in query tiles, so the (Q, N) matrix never exists whole
(at the 32768 bucket it would be 4 GB). The JAX package's
`method="approx"` is `jax.lax.approx_min_k`, a TPU operator that XLA
computes exactly on every other backend (recall 1.0); the port takes that
meaning (`check_knn_method`).
"""

from __future__ import annotations

import functools
import logging

import torch

from roitr_torch.kernels.knn_kernel import knn, min_dist
from roitr_torch.utils.profiling import span

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
    neighbor (reference knnquery_cuda_kernel.cu:65-108). On the card a
    search of more neighbours than the kernel's lists hold raises
    (knn_kernel.supported_k).
    """
    with span("knn", keys.device):
        return knn(queries, keys, key_count, k, exclude_self)


def masked_min_dist(queries: torch.Tensor, keys: torch.Tensor, key_count) -> torch.Tensor:
    """1-NN distance (no index) from each query to the valid keys: queries
    (Q, 3), keys (N, 3) with `key_count` valid prefix rows -> (Q,) sqrt
    distances, by per-coordinate differences (no x^2 - 2xy + y^2
    cancellation), as in the JAX package; the (Q, N) matrix never exists
    whole."""
    with span("knn", keys.device):
        return min_dist(queries, keys, key_count)


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
