"""Coarse and fine matching heads with fixed-capacity outputs.

Counterpart of roitr_tpu/models/matching.py (reference
model/modules.py:135-324): every head emits fixed-size index and score
buffers plus validity masks. Top-k ties go to the lower index
(ops/topk.py), as with the JAX package's lax.top_k.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from roitr_torch.ops.geometry import pairwise_sq_dist
from roitr_torch.ops.topk import topk


class CoarseCorr(NamedTuple):
    ref_indices: torch.Tensor  # (P,) int64
    src_indices: torch.Tensor  # (P,) int64
    scores: torch.Tensor  # (P,)
    masks: torch.Tensor  # (P,) bool


def coarse_matching(ref_feats, src_feats, ref_masks, src_masks, num_correspondences: int,
                    dual_normalization: bool = True) -> CoarseCorr:
    """Top-k superpoint matching by exp(-feature distance) similarity with
    dual row/col normalization (reference modules.py:135-178). Invalid
    rows/cols contribute zero similarity."""
    scores = torch.exp(-pairwise_sq_dist(ref_feats, src_feats))
    pair_mask = ref_masks[:, None] & src_masks[None, :]
    scores = torch.where(pair_mask, scores, torch.zeros_like(scores))
    if dual_normalization:
        ref_scores = scores / (torch.sum(scores, dim=1, keepdim=True) + 1e-8)
        src_scores = scores / (torch.sum(scores, dim=0, keepdim=True) + 1e-8)
        scores = ref_scores * src_scores
    n = scores.shape[1]
    k = min(num_correspondences, scores.numel())
    corr_scores, flat_idx = topk(scores.reshape(-1), k)
    return CoarseCorr(flat_idx // n, flat_idx % n, corr_scores, corr_scores > 0.0)


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U in [tiny, 1), as
    jax.random.gumbel. Drawn on the CPU generator and then moved, so a run
    on the card and one on the CPU with the same seed draw the same noise."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def gt_coarse_corr_generator(gt_corr_indices, gt_corr_overlaps, gt_corr_masks,
                             num_targets: int, overlap_threshold: float,
                             generator: Optional[torch.Generator] = None,
                             gumbel: Optional[torch.Tensor] = None) -> CoarseCorr:
    """Up to `num_targets` random GT correspondences with overlap above the
    threshold, without replacement, by Gumbel top-k over the eligible set
    (reference modules.py:181-213). The noise is drawn from `generator` (a
    CPU generator, see gumbel_noise) unless given as `gumbel` (C,)."""
    eligible = gt_corr_masks & (gt_corr_overlaps > overlap_threshold)
    if gumbel is None:
        if generator is None:
            raise ValueError("gt_coarse_corr_generator needs a generator or the gumbel noise")
        gumbel = gumbel_noise(gt_corr_overlaps.shape, generator, gt_corr_overlaps.device)
    keys = torch.where(eligible, gumbel.to(gt_corr_overlaps.device),
                       gumbel.new_full((), -math.inf, device=gt_corr_overlaps.device))
    _, sel = topk(keys, min(num_targets, keys.shape[0]))
    valid = eligible[sel]
    zero = torch.zeros_like(sel)
    ref_idx = torch.where(valid, gt_corr_indices[sel, 0], zero)
    src_idx = torch.where(valid, gt_corr_indices[sel, 1], zero)
    overlaps = torch.where(valid, gt_corr_overlaps[sel], torch.zeros_like(gt_corr_overlaps[sel]))
    return CoarseCorr(ref_idx, src_idx, overlaps, valid)


class FineCorr(NamedTuple):
    ref_points: torch.Tensor  # (P * cap, 3)
    src_points: torch.Tensor  # (P * cap, 3)
    scores: torch.Tensor  # (P * cap,)
    masks: torch.Tensor  # (P * cap,) bool


def _topk_mask(scores: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Boolean mask of the top-k entries along `dim` (reference
    modules.py:251-264, ties to the lower index)."""
    _, idx = topk(scores, k, dim=dim)
    mask = torch.zeros_like(scores, dtype=torch.bool)
    return mask.scatter(dim, idx, True)


def fine_matching(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, score_mat,
                  patch_masks, global_scores: Optional[torch.Tensor] = None, k: int = 3,
                  mutual: bool = True, confidence_threshold: float = 0.05,
                  use_global_score: bool = False, use_dustbin: bool = False,
                  allow_fast: bool = True) -> FineCorr:
    """Point matching inside matched patches (reference modules.py:216-324).

    A pair matches when its exp-score is in the row top-k (and, if mutual,
    the column top-k) and above the confidence threshold. The fast path
    (mutual, no dustbin) works in the (P, K, k) row-top-k slots: a kept
    pair always lies in its row's top-k, so that buffer holds the exact set;
    column membership is `logit >= k-th largest of the column`. The exact
    path extracts a per-patch top-(K*k) from the full (P, K, K) mask.
    """
    p = score_mat.shape[0]
    fast = allow_fast and mutual and not use_dustbin and k <= score_mat.shape[-1]
    if fast:
        kk = score_mat.shape[1]
        logits_top, ridx = topk(score_mat, k, dim=2)  # (P, K, k)
        col_sorted, _ = torch.topk(score_mat.transpose(1, 2), k, dim=-1)  # values only
        col_kth = col_sorted[..., -1]  # (P, K): k-th largest per src column
        base = (torch.arange(p, device=score_mat.device) * kk)[:, None, None]
        flat = base + ridx
        src_pts = src_knn_points.reshape(p * kk, 3)[flat]  # (P, K, k, 3)
        src_ok = src_knn_masks.reshape(p * kk)[flat]
        kth = col_kth.reshape(p * kk)[flat]
        log_thr = math.log(confidence_threshold) if confidence_threshold > 0 else -math.inf
        keep = ((logits_top > log_thr) & (logits_top >= kth) & src_ok
                & ref_knn_masks[:, :, None] & patch_masks[:, None, None])
        val = torch.exp(logits_top)
        if use_global_score and global_scores is not None:
            val = val * global_scores[:, None, None]
        val = torch.where(keep, val, torch.zeros_like(val))
        ref_pts = ref_knn_points[:, :, None, :].expand(p, kk, k, 3)
        return FineCorr(ref_pts.reshape(-1, 3), src_pts.reshape(-1, 3), val.reshape(-1),
                        (val > 0.0).reshape(-1))

    scores = torch.exp(score_mat)
    above = scores > confidence_threshold
    ref_corr = _topk_mask(scores, k, dim=2) & above
    src_corr = _topk_mask(scores, k, dim=1) & above
    corr_mat = (ref_corr & src_corr) if mutual else (ref_corr | src_corr)
    if use_dustbin:
        corr_mat = corr_mat[:, :-1, :-1]
        scores = scores[:, :-1, :-1]
    kk = corr_mat.shape[1]
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    corr_mat = corr_mat & mask_mat & patch_masks[:, None, None]
    if use_global_score and global_scores is not None:
        scores = scores * global_scores[:, None, None]
    scores = torch.where(corr_mat, scores, torch.zeros_like(scores))

    # matches per patch: <= K*k under AND, <= 2*K*k under OR
    cap = min(kk * k if mutual else 2 * kk * k, kk * kk)
    top_scores, flat_idx = topk(scores.reshape(p, kk * kk), cap, dim=1)
    base = torch.arange(p, device=scores.device)[:, None] * kk
    ref_pts = ref_knn_points.reshape(p * kk, 3)[base + flat_idx // kk]
    src_pts = src_knn_points.reshape(p * kk, 3)[base + flat_idx % kk]
    return FineCorr(ref_pts.reshape(-1, 3), src_pts.reshape(-1, 3), top_scores.reshape(-1),
                    (top_scores > 0.0).reshape(-1))
