"""Plain PyTorch operations of RoITr's reference equations, fp32, one pair.

A frozen copy of the equations the benchmark holds the port to: geometry,
top-k with lax.top_k's tie order, exact kNN, farthest point sampling,
normals, the point-to-node partition, ground-truth patch overlaps, coarse
and fine matching and the log-domain Sinkhorn iteration. No kernel, no
cache, no batching of pairs. Operations are written in the order in which
the equations round (distances as x^2 - 2xy + y^2, FPS distances left to
right), so that a correct implementation agrees with them to rounding.
This file imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INF = 1e10
_BIG = 1e12
_LOW32 = 0xFFFFFFFF
# distance entries per query tile of the exact kNN (the (Q, N) matrix at
# the 32768 bucket would be 4 GB whole)
_TILE_ELEMS = 1 << 25


# ---------------------------------------------------------------- geometry

def prefix_mask(n: int, count, device=None) -> torch.Tensor:
    return torch.arange(n, device=device) < torch.as_tensor(count, device=device)


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """(..., N, C) x (..., M, C) -> (..., N, M) squared distances,
    x^2 - 2xy + y^2 clamped at 1e-12 (RoITr lib/utils.py:139-156)."""
    xy = torch.matmul(x, y.transpose(-1, -2))
    if normalized:
        d2 = 2.0 - 2.0 * xy
    else:
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        d2 = x2 - 2.0 * xy + y2
    return torch.clamp(d2, min=1e-12)


def masked_pairwise_sq_dist(x, y, x_mask=None, y_mask=None, fill: float = INF):
    d2 = pairwise_sq_dist(x, y)
    fill_t = torch.tensor(fill, dtype=d2.dtype, device=d2.device)
    if y_mask is not None:
        d2 = torch.where(y_mask[..., None, :], d2, fill_t)
    if x_mask is not None:
        d2 = torch.where(x_mask[..., :, None], d2, fill_t)
    return d2


def _angle(a, b):
    y = torch.sum(a * b, dim=-1)
    x = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
    return torch.atan2(x, y)


def calc_ppf(points, point_normals, group_points, group_normals):
    """(N, 3), (N, K, 3) -> (N, K, 4) point-pair features
    [|d|, angle(n1, d)/pi, angle(n2, d)/pi, angle(n1, n2)/pi]."""
    c = points[..., :, None, :]
    nc = point_normals[..., :, None, :]
    vec_d = group_points - c
    d = torch.linalg.norm(vec_d, dim=-1, keepdim=True)
    a1 = _angle(nc.expand_as(vec_d), vec_d)[..., None] / math.pi
    a2 = _angle(group_normals, vec_d)[..., None] / math.pi
    a3 = _angle(nc.expand_as(group_normals), group_normals)[..., None] / math.pi
    return torch.cat([d, a1, a2, a3], dim=-1)


def apply_transform(points, rot, trans):
    return points @ rot.t() + trans.reshape(3)


# ------------------------------------------------------------------ top-k

def topk(values: torch.Tensor, k: int, dim: int = -1, largest: bool = True):
    """Sorted top-k, ties to the lower index (lax.top_k's order): each fp32
    value becomes an order-preserving int joined with its index."""
    v = values.movedim(dim, -1)
    bits = v.contiguous().view(torch.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    idx = torch.arange(v.shape[-1], device=v.device, dtype=torch.int64)
    key = key * (1 << 32) + ((_LOW32 - idx) if largest else idx)
    _, sel = torch.topk(key, k, dim=-1, largest=largest, sorted=True)
    return torch.gather(v, -1, sel).movedim(-1, dim), sel.movedim(-1, dim)


# -------------------------------------------------------------------- kNN

def masked_knn(queries, keys, key_count, k: int, exclude_self: bool = False):
    """k nearest of the `key_count` valid keys, ascending, ties to the lower
    index -> (idx (Q, k), sqrt distances). exclude_self drops the nearest
    and pads a short cloud's trailing slots with index 0 at the sentinel
    distance (RoITr's knnquery kernel)."""
    q, n = queries.shape[0], keys.shape[0]
    kk = min(k + 1 if exclude_self else k, n)
    count = torch.as_tensor(key_count, device=keys.device)
    key_invalid = torch.arange(n, device=keys.device) >= count
    inf = torch.tensor(INF, dtype=torch.float32, device=keys.device)
    tile = max(1, _TILE_ELEMS // max(n, 1))
    idx_parts, d2_parts = [], []
    for s in range(0, q, tile):
        d2 = pairwise_sq_dist(queries[s:s + tile], keys)
        d2 = torch.where(key_invalid[None, :], inf, d2)
        d, i = topk(d2, kk, dim=-1, largest=False)
        idx_parts.append(i)
        d2_parts.append(d)
    idx = torch.cat(idx_parts, dim=0)
    d2 = torch.cat(d2_parts, dim=0)
    if exclude_self:
        idx, d2 = idx[:, 1:], d2[:, 1:]
        if idx.shape[-1] < k:
            pad = (q, k - idx.shape[-1])
            idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
            d2 = torch.cat([d2, d2.new_full(pad, INF)], dim=-1)
        phantom = torch.arange(idx.shape[-1], device=idx.device) >= count - 1
        idx = torch.where(phantom, torch.zeros_like(idx), idx)
        d2 = torch.where(phantom, inf, d2)
    return idx, torch.sqrt(d2)


def masked_min_dist(queries, keys, key_count):
    """1-NN distance from each query to the valid keys, by coordinate
    differences (no cancellation)."""
    q, n = queries.shape[0], keys.shape[0]
    key_invalid = ~prefix_mask(n, key_count, device=keys.device)
    inf = torch.tensor(INF, dtype=torch.float32, device=keys.device)
    tile = max(1, _TILE_ELEMS // 4 // max(n, 1))
    parts = []
    for s in range(0, q, tile):
        t = queries[s:s + tile]
        d2 = sum((t[:, i, None] - keys[None, :, i]) ** 2 for i in range(3))
        parts.append(torch.where(key_invalid[None, :], inf, d2).amin(dim=1))
    return torch.sqrt(torch.cat(parts))


def three_nn_interpolate(parent_xyz, child_xyz, child_feats, child_count, k: int = 3):
    idx, dist = masked_knn(parent_xyz, child_xyz, child_count, k)
    recip = 1.0 / torch.clamp(dist, min=1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    return torch.sum(child_feats[idx] * weight[..., None], dim=1)


# -------------------------------------------------------------------- FPS

def furthest_point_sampling(points, counts, num_samples: int) -> torch.Tensor:
    """points (B, N, 3), counts (B,) -> (B, num_samples) int64: seed index
    0, each pick maximises the running min-distance (ties to the first),
    padded points never picked; distances round (dx dx + dy dy) + dz dz."""
    b, n, _ = points.shape
    valid = torch.arange(n, device=points.device)[None, :] < counts.to(points.device)[:, None]
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=points.device)
    dists = torch.where(valid, torch.tensor(1e10, dtype=torch.float32, device=points.device),
                        neg_inf)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = torch.arange(b, device=points.device)
    out = torch.zeros((b, num_samples), dtype=torch.int64, device=points.device)
    last = torch.zeros(b, dtype=torch.int64, device=points.device)
    for i in range(1, num_samples):
        sel = points[rows, last]
        dx = x - sel[:, 0:1]
        dy = y - sel[:, 1:2]
        dz = z - sel[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, torch.where(valid, d2, neg_inf))
        last = torch.argmax(dists, dim=1)
        out[:, i] = last
    return out


def num_valid_samples(count, stride: int):
    return torch.clamp(count // stride, min=1)


# ---------------------------------------------------------------- normals

def _det3(c0, c1, c2):
    return torch.sum(c0 * torch.linalg.cross(c1, c2, dim=-1), dim=-1)


def _smallest_eigvec_3x3(cov):
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3
    matrices: trigonometric eigenvalue, the largest cross product of two
    rows of (C - lam I), one step of inverse iteration."""
    a, b, c = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    d, f, e = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    q = (a + b + c) / 3.0
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * (d * d + f * f + e * e)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    iso = p < 1e-20
    ps = torch.where(iso, torch.ones_like(p), p)
    aq, bq, cq = (a - q) / ps, (b - q) / ps, (c - q) / ps
    dn, fn, en = d / ps, f / ps, e / ps
    detb = (aq * (bq * cq - en * en) - dn * (dn * cq - en * fn)
            + fn * (dn * en - bq * fn))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    m = cov - lam_min[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1), torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    norms2 = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms2, dim=-1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    good = torch.gather(norms2, -1, best[..., None]) > 1e-30
    z = torch.zeros_like(vec)
    z[..., 2] = 1.0
    vec = torch.where(good & ~iso[..., None], vec, z)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True)
    lam = torch.einsum("...i,...ij,...j->...", vec, cov, vec)
    m = cov - lam[..., None, None] * eye
    c0, c1, c2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    y = torch.stack([_det3(vec, c1, c2), _det3(c0, vec, c2), _det3(c0, c1, vec)], dim=-1)
    ny = torch.sum(y * y, dim=-1, keepdim=True)
    ok = ny > 1e-30
    return torch.where(ok, y / torch.sqrt(torch.where(ok, ny, torch.ones_like(ny))), vec)


def estimate_normals(points, count, k: int = 33):
    """PCA normals over the k nearest valid points (self included), facing
    the origin, zero past `count`."""
    idx, _ = masked_knn(points, points, count, k)
    count = torch.as_tensor(count, device=points.device)
    slot_valid = torch.arange(idx.shape[1], device=points.device)[None, :] < count
    neigh = points[idx]
    w = slot_valid[..., None].to(neigh.dtype)
    cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)
    mean = torch.sum(neigh * w, dim=1, keepdim=True) / cnt
    centered = (neigh - mean) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt
    normals = _smallest_eigvec_3x3(cov)
    vp = torch.zeros(3, dtype=points.dtype, device=points.device)
    flip = torch.sum((vp[None, :] - points) * normals, dim=-1) < 0.0
    normals = torch.where(flip[:, None], -normals, normals)
    valid = prefix_mask(points.shape[0], count, device=points.device)
    return torch.where(valid[:, None], normals, torch.zeros_like(normals))


def estimate_normals_host(points: np.ndarray, k: int = 33) -> np.ndarray:
    """The datasets' host normals: kNN-k PCA (scipy KD-tree, LAPACK
    eigenvectors), redirected toward the origin."""
    from scipy.spatial import cKDTree

    n = points.shape[0]
    k = min(k, n)
    _, idx = cKDTree(points).query(points, k=k)
    if k == 1:
        idx = idx[:, None]
    neigh = points[idx]
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[..., 0]
    normals = (normals / np.clip(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12,
                                 None)).astype(np.float32)
    flip = np.sum((np.zeros(3, np.float32) - points) * normals, axis=-1) < 0.0
    normals[flip] *= -1.0
    return normals


# -------------------------------------------------------------- partition

class Partition(NamedTuple):
    node_masks: torch.Tensor
    node_knn_indices: torch.Tensor
    node_knn_masks: torch.Tensor


def point_to_node_partition(points, nodes, point_limit: int, point_count, node_count):
    """Each point to its nearest node; a node keeps <= point_limit of its
    own points, nearest first, ties by index; other slots hold N."""
    n, m = points.shape[0], nodes.shape[0]
    dev = points.device
    pmask = prefix_mask(n, point_count, device=dev)
    nmask = prefix_mask(m, node_count, device=dev)
    sq = masked_pairwise_sq_dist(nodes, points, x_mask=nmask, y_mask=pmask, fill=_BIG)
    owner = torch.argmin(sq, dim=0)
    owner = torch.where(pmask, owner, torch.full_like(owner, m))
    d_own = torch.gather(sq, 0, torch.clamp(owner, max=max(m - 1, 0))[None, :])[0]
    by_dist = torch.sort(d_own, stable=True).indices
    by_owner = torch.sort(owner[by_dist], stable=True).indices
    sorted_idx = by_dist[by_owner]
    sorted_owner = owner[sorted_idx]
    idx = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          sorted_owner[1:] != sorted_owner[:-1]])
    seg_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=0).values
    rank = idx - seg_start
    valid = (sorted_owner < m) & (rank < point_limit)
    scat_owner = torch.where(valid, sorted_owner, torch.full_like(sorted_owner, m))
    scat_rank = torch.where(valid, rank, torch.full_like(rank, point_limit))
    knn = torch.full((m + 1, point_limit + 1), n, dtype=torch.int64, device=dev)
    knn[scat_owner, scat_rank] = sorted_idx
    knn_masks = torch.zeros((m + 1, point_limit + 1), dtype=torch.bool, device=dev)
    knn_masks[scat_owner, scat_rank] = True
    knn_masks = knn_masks[:m, :point_limit]
    return Partition(knn_masks[:, 0], knn[:m, :point_limit], knn_masks)


class NodeCorr(NamedTuple):
    indices: torch.Tensor  # (C, 2) [ref, src]
    overlaps: torch.Tensor
    masks: torch.Tensor


def node_correspondences(ref_nodes, src_nodes, ref_knn_points, src_knn_points, rot, trans,
                         pos_radius, ref_masks, src_masks, ref_knn_masks, src_knn_masks,
                         max_candidates: int, chunk: int = 2048) -> NodeCorr:
    """GT patch overlaps (RoITr lib/utils.py:530-614) over the top
    `max_candidates` node pairs by enclosing-sphere margin."""
    m, n = ref_knn_points.shape[0], src_knn_points.shape[0]
    src_nodes = apply_transform(src_nodes, rot, trans)
    src_knn_points = apply_transform(src_knn_points, rot, trans)
    node_mask_mat = ref_masks[:, None] & src_masks[None, :]
    zero = ref_knn_points.new_zeros(())
    ref_max = torch.where(ref_knn_masks, torch.linalg.norm(
        ref_knn_points - ref_nodes[:, None, :], dim=-1), zero).amax(dim=1)
    src_max = torch.where(src_knn_masks, torch.linalg.norm(
        src_knn_points - src_nodes[:, None, :], dim=-1), zero).amax(dim=1)
    dist = torch.sqrt(pairwise_sq_dist(ref_nodes, src_nodes))
    margin = ref_max[:, None] + src_max[None, :] + pos_radius - dist
    intersect = (margin > 0) & node_mask_mat
    c = min(max_candidates, m * n)
    flat_margin = torch.where(intersect, margin, margin.new_full((), -_BIG)).reshape(-1)
    top_margin, flat_idx = topk(flat_margin, c)
    cand_mask = top_margin > -_BIG
    ref_idx, src_idx = flat_idx // n, flat_idx % n
    overlaps = []
    for s in range(0, c, chunk):
        ri, si = ref_idx[s:s + chunk], src_idx[s:s + chunk]
        rkm, skm = ref_knn_masks[ri], src_knn_masks[si]
        diff = ref_knn_points[ri][:, :, None, :] - src_knn_points[si][:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
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
    return NodeCorr(indices, overlaps, valid)


# --------------------------------------------------------------- matching

class CoarseCorr(NamedTuple):
    ref_indices: torch.Tensor
    src_indices: torch.Tensor
    scores: torch.Tensor
    masks: torch.Tensor


def coarse_matching(ref_feats, src_feats, ref_masks, src_masks, num_corr: int) -> CoarseCorr:
    """Top-k node pairs by exp(-distance^2), dual-normalised (RoITr
    modules.py:135-178)."""
    scores = torch.exp(-pairwise_sq_dist(ref_feats, src_feats))
    scores = torch.where(ref_masks[:, None] & src_masks[None, :], scores, torch.zeros_like(scores))
    ref_scores = scores / (torch.sum(scores, dim=1, keepdim=True) + 1e-8)
    src_scores = scores / (torch.sum(scores, dim=0, keepdim=True) + 1e-8)
    scores = ref_scores * src_scores
    n = scores.shape[1]
    corr_scores, flat_idx = topk(scores.reshape(-1), min(num_corr, scores.numel()))
    return CoarseCorr(flat_idx // n, flat_idx % n, corr_scores, corr_scores > 0.0)


def adaptive_superpoint_matching(src_feats, tgt_feats, src_masks, tgt_masks, min_num: int,
                                 capacity: int, threshold: float) -> CoarseCorr:
    """Node pairs whose normalised feature distance is under the threshold,
    at least the `min_num` nearest, in a buffer of `capacity` (RoITr
    modules.py:75-124). Returns (src, tgt) as ref_indices, src_indices."""
    dist = torch.sqrt(pairwise_sq_dist(src_feats, tgt_feats, normalized=True))
    dist = torch.where(src_masks[:, None] & tgt_masks[None, :], dist,
                       torch.full_like(dist, math.inf))
    n = dist.shape[1]
    cap = min(capacity, dist.numel())
    corr_dist, flat_idx = topk(dist.reshape(-1), cap, largest=False)
    rank = torch.arange(cap, device=dist.device)
    valid = torch.isfinite(corr_dist) & ((corr_dist <= threshold) | (rank < min(min_num, cap)))
    scores = torch.where(valid, torch.exp(-corr_dist), torch.zeros_like(corr_dist))
    return CoarseCorr(flat_idx // n, flat_idx % n, scores, valid)


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def gt_coarse_corr_sample(corr: NodeCorr, num_targets: int, overlap_threshold: float,
                          generator: torch.Generator) -> CoarseCorr:
    """Up to `num_targets` GT pairs above the overlap threshold, without
    replacement, by Gumbel top-k (RoITr modules.py:181-213)."""
    eligible = corr.masks & (corr.overlaps > overlap_threshold)
    gumbel = gumbel_noise(corr.overlaps.shape, generator, corr.overlaps.device)
    keys = torch.where(eligible, gumbel, gumbel.new_full((), -math.inf))
    _, sel = topk(keys, min(num_targets, keys.shape[0]))
    valid = eligible[sel]
    zero = torch.zeros_like(sel)
    ref_idx = torch.where(valid, corr.indices[sel, 0], zero)
    src_idx = torch.where(valid, corr.indices[sel, 1], zero)
    overlaps = torch.where(valid, corr.overlaps[sel], torch.zeros_like(corr.overlaps[sel]))
    return CoarseCorr(ref_idx, src_idx, overlaps, valid)


def fine_matching(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, score_mat,
                  patch_masks, k: int, confidence_threshold: float):
    """Mutual top-k point matches above the threshold inside each patch
    pair (RoITr modules.py:216-324, no dustbin, no global score) ->
    (ref points, src points, scores, masks), K * k slots a patch."""
    p, kk = score_mat.shape[0], score_mat.shape[1]
    scores = torch.exp(score_mat)
    above = scores > confidence_threshold

    def topk_mask(s, dim):
        _, i = topk(s, k, dim=dim)
        return torch.zeros_like(s, dtype=torch.bool).scatter(dim, i, True)

    corr_mat = topk_mask(scores, 2) & above & topk_mask(scores, 1)
    corr_mat = corr_mat & ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    corr_mat = corr_mat & patch_masks[:, None, None]
    scores = torch.where(corr_mat, scores, torch.zeros_like(scores))
    cap = min(kk * k, kk * kk)
    top_scores, flat_idx = topk(scores.reshape(p, kk * kk), cap, dim=1)
    base = torch.arange(p, device=scores.device)[:, None] * kk
    ref_pts = ref_knn_points.reshape(p * kk, 3)[base + flat_idx // kk]
    src_pts = src_knn_points.reshape(p * kk, 3)[base + flat_idx % kk]
    return (ref_pts.reshape(-1, 3), src_pts.reshape(-1, 3), top_scores.reshape(-1),
            (top_scores > 0.0).reshape(-1))


# --------------------------------------------------------------- Sinkhorn

def log_sinkhorn_ot(scores, row_masks, col_masks, alpha, num_iter: int):
    """Masked log-domain Sinkhorn with a dustbin row and column (RoITr
    model/modules.py:10-72): scores (P, M, N) -> (P, M+1, N+1)."""
    neg_big = 1e6
    b, m, n = scores.shape
    dev = scores.device
    zeros = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    row_invalid = torch.cat([~row_masks, zeros], dim=1)
    col_invalid = torch.cat([~col_masks, zeros], dim=1)
    padded = torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
                        alpha.expand(b, 1, n + 1)], dim=1)
    neg = torch.tensor(-neg_big, dtype=torch.float32, device=dev)
    padded = torch.where(row_invalid[:, :, None] | col_invalid[:, None, :], neg, padded)
    nrow = torch.clamp(row_masks.sum(dim=1).to(torch.float32), min=1.0)
    ncol = torch.clamp(col_masks.sum(dim=1).to(torch.float32), min=1.0)
    norm = -torch.log(nrow + ncol)
    log_mu = torch.cat([norm[:, None].expand(b, m), (torch.log(ncol) + norm)[:, None]], dim=1)
    log_mu = torch.where(row_invalid, neg, log_mu)
    log_nu = torch.cat([norm[:, None].expand(b, n), (torch.log(nrow) + norm)[:, None]], dim=1)
    log_nu = torch.where(col_invalid, neg, log_nu)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iter):
        u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
    return padded + u[:, :, None] + v[:, None, :] - norm[:, None, None]
