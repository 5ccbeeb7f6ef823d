"""Losses and the online evaluator (pure functions of the forward's dict).

Counterpart of roitr_tpu/losses.py (reference lib/loss.py:8-214): the
fixed-capacity GT correspondence list is scattered into a dense overlap
map, and every "boolean index, then mean" of the reference is a masked
mean.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from roitr_torch.config import Config
from roitr_torch.ops.geometry import apply_transform, pairwise_sq_dist, prefix_mask


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def weighted_circle_loss(pos_masks, neg_masks, feat_dists, pos_margin: float, neg_margin: float,
                         pos_optimal: float, neg_optimal: float, log_scale: float,
                         pos_scales=None, valid_rows=None, valid_cols=None) -> torch.Tensor:
    """Reference lib/loss.py:8-49, with row/col validity masks that keep
    padded nodes out of the anchor means. The weights get no gradient."""
    row_masks = (pos_masks.sum(-1) > 0) & (neg_masks.sum(-1) > 0)
    col_masks = (pos_masks.sum(-2) > 0) & (neg_masks.sum(-2) > 0)
    if valid_rows is not None:
        row_masks = row_masks & valid_rows
    if valid_cols is not None:
        col_masks = col_masks & valid_cols

    pos_weights = feat_dists - 1e5 * (~pos_masks).to(feat_dists.dtype)
    pos_weights = torch.clamp(pos_weights - pos_optimal, min=0.0)
    if pos_scales is not None:
        pos_weights = pos_weights * pos_scales
    pos_weights = pos_weights.detach()
    neg_weights = feat_dists + 1e5 * (~neg_masks).to(feat_dists.dtype)
    neg_weights = torch.clamp(neg_optimal - neg_weights, min=0.0).detach()

    pos = log_scale * (feat_dists - pos_margin) * pos_weights
    neg = log_scale * (neg_margin - feat_dists) * neg_weights
    loss_row = F.softplus(torch.logsumexp(pos, dim=-1) + torch.logsumexp(neg, dim=-1)) / log_scale
    loss_col = F.softplus(torch.logsumexp(pos, dim=-2) + torch.logsumexp(neg, dim=-2)) / log_scale
    return (_masked_mean(loss_row, row_masks) + _masked_mean(loss_col, col_masks)) / 2.0


def gt_overlap_map(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fixed-capacity GT correspondence list as a dense (M_tgt, N_src)
    overlap map (reference loss.py:102-103). Invalid slots point at (0, 0)
    with overlap 0 and valid pairs are unique, so an accumulating put of the
    masked overlaps is the JAX package's set, and deterministic on the card
    (a plain put with duplicate indices is not)."""
    m = out["tgt_node_feats"].shape[0]
    n = out["src_node_feats"].shape[0]
    idx = out["gt_node_corr_indices"]
    ov = torch.where(out["gt_node_corr_masks"], out["gt_node_corr_overlaps"],
                     torch.zeros_like(out["gt_node_corr_overlaps"]))
    dense = torch.zeros((m, n), dtype=ov.dtype, device=ov.device)
    return dense.index_put_((idx[:, 0], idx[:, 1]), ov, accumulate=True)


def coarse_matching_loss(cfg: Config, out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Overlap-weighted circle loss over node descriptor distances
    (reference lib/loss.py:76-111)."""
    tgt_feats = out["tgt_node_feats"]
    src_feats = out["src_node_feats"]
    feat_dists = torch.sqrt(pairwise_sq_dist(tgt_feats, src_feats))  # clamped: finite gradient

    overlaps = gt_overlap_map(out)
    pos_masks = overlaps > cfg.coarse_loss_positive_overlap
    neg_masks = overlaps == 0.0
    pos_scales = torch.sqrt(overlaps * pos_masks)  # no gradient reaches it

    tgt_valid = prefix_mask(tgt_feats.shape[0], out["tgt_node_count"], device=tgt_feats.device)
    src_valid = prefix_mask(src_feats.shape[0], out["src_node_count"], device=src_feats.device)
    # padded nodes: out of both the positive and the negative set
    neg_masks = neg_masks & tgt_valid[:, None] & src_valid[None, :]
    return weighted_circle_loss(
        pos_masks, neg_masks, feat_dists, cfg.coarse_loss_positive_margin,
        cfg.coarse_loss_negative_margin, cfg.coarse_loss_positive_optimal,
        cfg.coarse_loss_negative_optimal, cfg.coarse_loss_log_scale, pos_scales=pos_scales,
        valid_rows=tgt_valid, valid_cols=src_valid)


def fine_matching_loss(cfg: Config, out: Dict[str, torch.Tensor], rot, trans) -> torch.Tensor:
    """Negative mean OT log-score over GT-matched point pairs, slack row
    and column labels included (reference lib/loss.py:114-143)."""
    tgt_masks = out["tgt_node_corr_knn_masks"]  # (P, K)
    src_masks = out["src_node_corr_knn_masks"]
    scores = out["matching_scores"]  # (P, K+1, K+1)
    src_pts = apply_transform(out["src_node_corr_knn_points"], rot, trans)
    dists = pairwise_sq_dist(out["tgt_node_corr_knn_points"], src_pts)  # (P, K, K)
    gt_corr = ((dists < cfg.fine_loss_positive_radius ** 2)
               & tgt_masks[:, :, None] & src_masks[:, None, :])
    slack_row = (gt_corr.sum(2) == 0) & tgt_masks
    slack_col = (gt_corr.sum(1) == 0) & src_masks
    k = tgt_masks.shape[1]
    labels = torch.zeros_like(scores, dtype=torch.bool)
    labels[:, :k, :k] = gt_corr
    labels[:, :k, k] = slack_row
    labels[:, k, :k] = slack_col
    return -_masked_mean(scores, labels)


def overall_loss(cfg: Config, out: Dict[str, torch.Tensor], rot, trans) -> Dict[str, torch.Tensor]:
    """Reference lib/loss.py:146-166."""
    c_loss = coarse_matching_loss(cfg, out)
    f_loss = fine_matching_loss(cfg, out, rot, trans)
    loss = cfg.coarse_loss_weight * c_loss + cfg.fine_loss_weight * f_loss
    return {"loss": loss, "c_loss": c_loss, "f_loss": f_loss, "o_loss": 0.0 * f_loss}


def evaluate_coarse(cfg: Config, out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """PIR: precision of the predicted node correspondences against the GT
    map (reference lib/loss.py:176-193)."""
    overlaps = gt_overlap_map(out)
    gt_map = (overlaps > cfg.eval_acceptance_overlap) & (overlaps > 0)
    hits = gt_map[out["tgt_node_corr_indices"], out["src_node_corr_indices"]]
    return _masked_mean(hits.to(torch.float32), out["node_corr_masks"])


def evaluate_fine(cfg: Config, out: Dict[str, torch.Tensor], rot, trans) -> torch.Tensor:
    """IR: share of the extracted correspondences within the acceptance
    radius after the GT transform (reference lib/loss.py:196-206)."""
    src = apply_transform(out["src_corr_points"], rot, trans)
    d = torch.linalg.norm(out["tgt_corr_points"] - src, dim=-1)
    return _masked_mean((d < cfg.eval_acceptance_radius).to(torch.float32), out["corr_masks"])


def evaluate(cfg: Config, out: Dict[str, torch.Tensor], rot, trans) -> Dict[str, torch.Tensor]:
    return {"PIR": evaluate_coarse(cfg, out), "IR": evaluate_fine(cfg, out, rot, trans)}
