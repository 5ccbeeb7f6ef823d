"""Point-to-node partition and ground-truth patch correspondences.

Counterpart of roitr_tpu/ops/partition.py (reference lib/utils.py:428-614):
every output is a fixed-capacity buffer plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from roitr_torch.ops.geometry import (
    apply_transform,
    masked_pairwise_sq_dist,
    pairwise_sq_dist,
    prefix_mask,
)
from roitr_torch.ops.neighbors import masked_min_dist
from roitr_torch.ops.topk import topk

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


class NodeCorrespondences(NamedTuple):
    indices: torch.Tensor  # (C, 2) int64 [ref, src]
    overlaps: torch.Tensor  # (C,) float
    masks: torch.Tensor  # (C,) bool


def node_correspondences(ref_nodes, src_nodes, ref_knn_points, src_knn_points, rot, trans,
                         pos_radius: float, ref_masks, src_masks, ref_knn_masks, src_knn_masks,
                         max_candidates: int = 16384, chunk: int = 2048) -> NodeCorrespondences:
    """Ground-truth patch overlaps between node pairs (reference
    lib/utils.py:530-614): src geometry moves into the ref frame, pairs are
    prefiltered by enclosing-sphere intersection, and a pair's overlap is
    the mean of the two directed fractions of patch points with a
    counterpart within pos_radius. The top `max_candidates` pairs by
    intersection margin (ties to the lower flat index, as lax.top_k) form
    the fixed-size candidate list, processed in (chunk, K, K) blocks.
    Invalid slots carry index (0, 0) and overlap 0."""
    m = ref_knn_points.shape[0]
    n = src_knn_points.shape[0]
    src_nodes = apply_transform(src_nodes, rot, trans)
    src_knn_points = apply_transform(src_knn_points, rot, trans)
    node_mask_mat = ref_masks[:, None] & src_masks[None, :]

    zero = ref_knn_points.new_zeros(())
    ref_max = torch.where(ref_knn_masks, torch.linalg.norm(
        ref_knn_points - ref_nodes[:, None, :], dim=-1), zero).amax(dim=1)  # (M,)
    src_max = torch.where(src_knn_masks, torch.linalg.norm(
        src_knn_points - src_nodes[:, None, :], dim=-1), zero).amax(dim=1)  # (N,)
    dist = torch.sqrt(pairwise_sq_dist(ref_nodes, src_nodes))
    margin = ref_max[:, None] + src_max[None, :] + pos_radius - dist
    intersect = (margin > 0) & node_mask_mat

    c = min(max_candidates, m * n)
    flat_margin = torch.where(intersect, margin, margin.new_full((), -_BIG)).reshape(-1)
    top_margin, flat_idx = topk(flat_margin, c)
    cand_mask = top_margin > -_BIG
    ref_idx = flat_idx // n
    src_idx = flat_idx % n

    overlaps = []
    for s in range(0, c, chunk):
        ri, si = ref_idx[s:s + chunk], src_idx[s:s + chunk]
        rkm, skm = ref_knn_masks[ri], src_knn_masks[si]
        diff = ref_knn_points[ri][:, :, None, :] - src_knn_points[si][:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)  # (c, K, K), no x^2 - 2xy + y^2 cancellation
        hit = (d2 < pos_radius ** 2) & rkm[:, :, None] & skm[:, None, :]
        ref_cnt = hit.any(dim=-1).sum(dim=-1).to(torch.float32)
        src_cnt = hit.any(dim=-2).sum(dim=-1).to(torch.float32)
        ref_tot = torch.clamp(rkm.sum(dim=-1).to(torch.float32), min=1.0)
        src_tot = torch.clamp(skm.sum(dim=-1).to(torch.float32), min=1.0)
        overlaps.append((ref_cnt / ref_tot + src_cnt / src_tot) / 2.0)
    overlaps = torch.cat(overlaps)

    valid = cand_mask & (overlaps > 0)
    overlaps = torch.where(valid, overlaps, torch.zeros_like(overlaps))
    indices = torch.stack([ref_idx, src_idx], dim=1)
    indices = torch.where(valid[:, None], indices, torch.zeros_like(indices))
    return NodeCorrespondences(indices, overlaps, valid)


def node_occlusion_score(ref_knn_point_ids, src_knn_point_ids, ref_points, src_points, ref_count,
                         src_count, rot, trans, ref_masks, src_masks, ref_knn_masks,
                         src_knn_masks, overlap_thres: float = 0.0375):
    """Per-node visibility in [0, 1] from 1-NN cross-cloud distances
    (reference lib/utils.py:474-527). `ref_points` / `src_points` are the
    padded arrays (N+1 rows, the last one zero) that the partition's kNN ids
    index; as keys, only the `count` valid rows count, so the zero pad row
    is never a neighbour (the JAX package's deliberate divergence,
    ARCHITECTURE.md)."""
    src_points_t = apply_transform(src_points, rot, trans)
    ref_d = masked_min_dist(ref_points, src_points_t, src_count)
    src_d = masked_min_dist(src_points_t, ref_points, ref_count)
    ref_overlap = (ref_d < overlap_thres).to(torch.float32)
    src_overlap = (src_d < overlap_thres).to(torch.float32)
    rkm = ref_knn_masks.to(torch.float32)
    skm = src_knn_masks.to(torch.float32)
    ref_score = (ref_overlap[ref_knn_point_ids] * rkm).sum(dim=1) / (rkm.sum(dim=1) + 1e-10)
    src_score = (src_overlap[src_knn_point_ids] * skm).sum(dim=1) / (skm.sum(dim=1) + 1e-10)
    return ref_score * ref_masks, src_score * src_masks
