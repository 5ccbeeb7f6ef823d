"""GeoTransformer (Qin et al., CVPR 2022; qinzheng93/GeoTransformer,
geotransformer.3dmatch.stage4.gse.k3.max.oacl.stage2.sinkhorn) for one pair.

grid pyramid (ops/grid.py, built by the caller) -> KPConv-FPN backbone
(models/kpconv.py) -> the geometric transformer over the stage-4 nodes of
each cloud (transformer.py with `positional=False`: the geo_embedding and
rpe_attention kernels) -> L2-normalised coarse features -> point-to-node
partition of the stage-2 points into patches -> dual-normalised coarse
matching -> patch OT (the sinkhorn kernel) -> mutual top-k fine matching
-> local-to-global registration (models/registration.py). The reference
cloud is the target: correspondences and the transform take the source
onto it. Stages hold both clouds stacked, the reference first, so the
stage's lengths (host ints) split them without a read. Inference only.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from roitr_torch.config import Config
from roitr_torch.models.kpconv import KPConvFPN, init_kpconv_weights
from roitr_torch.models.matching import coarse_matching, fine_matching
from roitr_torch.models.roitr import LearnableLogOptimalTransport, init_weights, resolve_device
from roitr_torch.models.registration import local_to_global_registration
from roitr_torch.models.transformer import GeometricTransformer
from roitr_torch.ops.grid import NUM_STAGES, GridPyramid
from roitr_torch.ops.partition import point_to_node_partition
from roitr_torch.ops.sinkhorn import SINKHORN_BACKENDS, log_sinkhorn_ot
from roitr_torch.utils.profiling import span


class GeoTransformer(nn.Module):
    """The matching pipeline; `state_dict()` has upstream's key layout
    (backbone.*, transformer.*, optimal_transport.alpha), the KPConv kernel
    points included."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.sinkhorn_backend not in SINKHORN_BACKENDS:
            raise ValueError(f"sinkhorn_backend must be one of {SINKHORN_BACKENDS}, got "
                             f"{cfg.sinkhorn_backend!r}")
        if len(cfg.neighbor_limits) != NUM_STAGES:
            raise ValueError(f"GeoTransformer's 3DMatch backbone has {NUM_STAGES} stages, one "
                             f"neighbour limit each: got {tuple(cfg.neighbor_limits)}")
        if cfg.compute_dtype != "float32":
            raise ValueError("GeoTransformer runs in float32")
        if cfg.fine_matching_use_dustbin:
            raise ValueError("GeoTransformer's fine matching drops the dustbin "
                             "(fine_matching_use_dustbin must be False)")
        device = resolve_device(device)
        self.cfg = cfg
        self.backbone = KPConvFPN(
            1, cfg.output_dim, cfg.init_dim, cfg.kernel_size, cfg.base_radius * cfg.voxel_size,
            cfg.base_sigma * cfg.voxel_size, cfg.group_norm)
        self.transformer = GeometricTransformer(
            16 * cfg.init_dim, 256, 256, cfg.num_heads,
            tuple(cfg.transformer_architecture), embedding_storage=cfg.geo_embedding_storage,
            positional=False)
        self.optimal_transport = LearnableLogOptimalTransport()
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, gen)
        init_kpconv_weights(self, gen)
        self.to(device)
        self.device = device

    def forward(self, pyr: GridPyramid) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        dev = self.device
        (r_f, _), (r_c, _) = pyr.lengths[1], pyr.lengths[3]
        points_f, points_c = pyr.points[1], pyr.points[3]
        with span("model.backbone", dev):
            feats = torch.ones((pyr.points[0].shape[0], 1), dtype=torch.float32, device=dev)
            feats_f, feats_c = self.backbone(feats, pyr)
        with span("model.transformer", dev):
            ref_c, src_c = self.transformer(points_c[:r_c], points_c[r_c:], feats_c[:r_c],
                                            feats_c[r_c:])
            ref_c = F.normalize(ref_c, dim=-1, eps=1e-12)
            src_c = F.normalize(src_c, dim=-1, eps=1e-12)
        with span("model.matching", dev):
            ref_pts_f, src_pts_f = points_f[:r_f], points_f[r_f:]
            ref_part = point_to_node_partition(ref_pts_f, points_c[:r_c], cfg.point_per_patch)
            src_part = point_to_node_partition(src_pts_f, points_c[r_c:], cfg.point_per_patch)
            corr = coarse_matching(ref_c, src_c, ref_part.node_masks, src_part.node_masks,
                                   cfg.num_est_coarse_corr, dual_normalization=True)
            zrow = points_f.new_zeros((1, 3))
            ref_idx = ref_part.node_knn_indices[corr.ref_indices]  # (P, K)
            src_idx = src_part.node_knn_indices[corr.src_indices]
            ref_knn_pts = torch.cat([ref_pts_f, zrow])[ref_idx]
            src_knn_pts = torch.cat([src_pts_f, zrow])[src_idx]
            ref_masks = ref_part.node_knn_masks[corr.ref_indices] & corr.masks[:, None]
            src_masks = src_part.node_knn_masks[corr.src_indices] & corr.masks[:, None]
            zfeat = feats_f.new_zeros((1, feats_f.shape[1]))
            ref_knn_feats = torch.cat([feats_f[:r_f], zfeat])[ref_idx]
            src_knn_feats = torch.cat([feats_f[r_f:], zfeat])[src_idx]
            with span("model.ot", dev):
                scores = torch.einsum("pnc,pmc->pnm", ref_knn_feats, src_knn_feats)
                scores = log_sinkhorn_ot(scores / feats_f.shape[1] ** 0.5, ref_masks, src_masks,
                                         self.optimal_transport.alpha, num_iter=cfg.sinkhorn_iters,
                                         tol=cfg.sinkhorn_tol, backend=cfg.sinkhorn_backend)
            fine = fine_matching(
                ref_knn_pts, src_knn_pts, ref_masks, src_masks, scores[:, :-1, :-1], corr.masks,
                global_scores=corr.scores, k=cfg.fine_matching_topk,
                mutual=cfg.fine_matching_mutual,
                confidence_threshold=cfg.fine_matching_confidence_threshold,
                use_global_score=cfg.fine_matching_use_global_score)
        with span("model.lgr", dev):
            transform = local_to_global_registration(
                fine.ref_points, fine.src_points, fine.scores, fine.masks,
                patches=corr.masks.shape[0],
                min_corr=cfg.fine_matching_correspondence_threshold,
                acceptance_radius=cfg.acceptance_radius, steps=cfg.num_refinement_steps)
        return {
            "tgt_corr_points": fine.ref_points, "src_corr_points": fine.src_points,
            "corr_scores": fine.scores, "corr_masks": fine.masks, "transform": transform,
            "tgt_points": ref_pts_f, "src_points": src_pts_f,
            "tgt_nodes": points_c[:r_c], "src_nodes": points_c[r_c:],
            "tgt_point_feats": feats_f[:r_f], "src_point_feats": feats_f[r_f:],
            "tgt_node_feats": ref_c, "src_node_feats": src_c,
        }
