"""Point-to-node partition.

Counterpart of roitr_tpu/ops/partition.py `point_to_node_partition`
(reference lib/utils.py:428-471). The ground-truth outputs
(`node_correspondences`, `node_occlusion_score`) belong to the with_gt
path, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from roitr_torch.ops.geometry import masked_pairwise_sq_dist, prefix_mask

_BIG = 1e12


class Partition(NamedTuple):
    point_to_node: torch.Tensor  # (N,) int64
    node_masks: torch.Tensor  # (M,) bool — node owns >= 1 point
    node_knn_indices: torch.Tensor  # (M, K) int64, padded entries = N
    node_knn_masks: torch.Tensor  # (M, K) bool


def point_to_node_partition(points, nodes, point_limit: int, point_count=None,
                            node_count=None) -> Partition:
    """Assign each point to its nearest node; per node keep <= point_limit
    own points, nearest first, ties by point index. A node's list holds
    only points whose nearest node it is; other slots are masked and hold
    N, the index of a zero row the caller appends."""
    n, m = points.shape[0], nodes.shape[0]
    dev = points.device
    pmask = (prefix_mask(n, point_count, device=dev) if point_count is not None
             else torch.ones(n, dtype=torch.bool, device=dev))
    nmask = (prefix_mask(m, node_count, device=dev) if node_count is not None
             else torch.ones(m, dtype=torch.bool, device=dev))

    sq = masked_pairwise_sq_dist(nodes, points, x_mask=nmask, y_mask=pmask, fill=_BIG)  # (M, N)
    point_to_node = torch.argmin(sq, dim=0)  # first minimum
    point_to_node = torch.where(pmask, point_to_node, torch.full_like(point_to_node, m))

    # one order by (owner, distance, index): two stable sorts, the minor
    # key first, equal to the JAX package's single two-key stable sort
    d_own = torch.gather(sq, 0, torch.clamp(point_to_node, max=max(m - 1, 0))[None, :])[0]
    by_dist = torch.sort(d_own, stable=True).indices
    by_owner = torch.sort(point_to_node[by_dist], stable=True).indices
    sorted_idx = by_dist[by_owner]
    sorted_owner = point_to_node[sorted_idx]

    idx = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_owner[1:] != sorted_owner[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=0).values
    rank = idx - seg_start  # position of each point within its owner's segment

    valid = (sorted_owner < m) & (rank < point_limit)
    # invalid entries land in a spare row/column that is cut off below
    scat_owner = torch.where(valid, sorted_owner, torch.full_like(sorted_owner, m))
    scat_rank = torch.where(valid, rank, torch.full_like(rank, point_limit))
    knn = torch.full((m + 1, point_limit + 1), n, dtype=torch.int64, device=dev)
    knn[scat_owner, scat_rank] = sorted_idx
    knn_masks = torch.zeros((m + 1, point_limit + 1), dtype=torch.bool, device=dev)
    knn_masks[scat_owner, scat_rank] = True
    node_knn_indices = knn[:m, :point_limit]
    node_knn_masks = knn_masks[:m, :point_limit]
    return Partition(point_to_node, node_knn_masks[:, 0], node_knn_indices, node_knn_masks)
