"""One-call correspondence inference on raw point clouds.

Counterpart of roitr_tpu/serving.py `Matcher.match`: host preprocessing
(normal estimation + view-point redirect + bucket padding), the pipeline on
the device, and the fixed-capacity outputs trimmed back to ragged numpy.

    matcher = Matcher(cfg, state_dict)          # device="cuda" by default
    out = matcher.match(src_xyz, tgt_xyz)       # (n, 3) float numpy each
    out["src_corr_pts"], out["tgt_corr_pts"], out["confidence"]

Normals are estimated as the datasets do (kNN-33 PCA + view-point
redirect, reference dataset/tdmatch.py:120-127); pass `src_normals` /
`tgt_normals` to skip that. Batched matching and device-side prep are
later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from roitr_torch.config import Config
from roitr_torch.data.preprocess import (
    estimate_normals_np,
    normal_redirect_np,
    pad_cloud,
    pick_bucket,
)
from roitr_torch.models.roitr import PairInputs, RoITr


class Matcher:
    """Serving wrapper around the RoITr pipeline."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor], device="cuda",
                 descriptors: bool = False):
        self.cfg = cfg
        self.descriptors = descriptors
        self.model = RoITr(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self.device = self.model.device

    def _prepare(self, src_pcd, tgt_pcd, src_normals, tgt_normals) -> PairInputs:
        cfg = self.cfg
        view = np.zeros(3, np.float32)  # datasets redirect toward the origin
        if src_normals is None:
            src_normals = normal_redirect_np(src_pcd, estimate_normals_np(src_pcd, cfg.normal_knn),
                                             view)
        if tgt_normals is None:
            tgt_normals = normal_redirect_np(tgt_pcd, estimate_normals_np(tgt_pcd, cfg.normal_knn),
                                             view)
        bucket = pick_bucket(max(len(src_pcd), len(tgt_pcd)), cfg.buckets)
        s_pts, s_nrm, s_feats, s_cnt = pad_cloud(src_pcd, src_normals, bucket)
        t_pts, t_nrm, t_feats, t_cnt = pad_cloud(tgt_pcd, tgt_normals, bucket)
        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        count = lambda c: torch.tensor(int(c), dtype=torch.int64, device=dev)
        src = t(s_pts)
        return PairInputs(src_points=src, src_raw_points=src, src_normals=t(s_nrm),
                          src_feats=t(s_feats), src_count=count(s_cnt), tgt_points=t(t_pts),
                          tgt_normals=t(t_nrm), tgt_feats=t(t_feats), tgt_count=count(t_cnt))

    @torch.no_grad()
    def match(self, src_pcd: np.ndarray, tgt_pcd: np.ndarray,
              src_normals: Optional[np.ndarray] = None,
              tgt_normals: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Dense correspondences between two raw clouds.

        Returns src_corr_pts/tgt_corr_pts (C, 3) and confidence (C,), C
        data-dependent; with descriptors=True also the node and point
        descriptors, trimmed to the valid counts."""
        src_pcd = np.ascontiguousarray(src_pcd, np.float32)
        tgt_pcd = np.ascontiguousarray(tgt_pcd, np.float32)
        # cap to the dataset limit and the largest bucket by a random subset
        # (reference dataset/tdmatch.py:72-78); given normals follow the
        # same permutation
        limit = min(self.cfg.points_limit, max(self.cfg.buckets))
        if len(src_pcd) > limit or len(tgt_pcd) > limit:
            rng = np.random.RandomState(0)
            if len(src_pcd) > limit:
                idx = rng.permutation(len(src_pcd))[:limit]
                src_pcd = src_pcd[idx]
                if src_normals is not None:
                    src_normals = np.asarray(src_normals, np.float32)[idx]
            if len(tgt_pcd) > limit:
                idx = rng.permutation(len(tgt_pcd))[:limit]
                tgt_pcd = tgt_pcd[idx]
                if tgt_normals is not None:
                    tgt_normals = np.asarray(tgt_normals, np.float32)[idx]
        pair = self._prepare(src_pcd, tgt_pcd, src_normals, tgt_normals)
        out = self.model(pair)
        mask = out["corr_masks"]
        res = {
            "src_corr_pts": out["src_corr_points"][mask].cpu().numpy(),
            "tgt_corr_pts": out["tgt_corr_points"][mask].cpu().numpy(),
            "confidence": out["corr_scores"][mask].cpu().numpy(),
        }
        if self.descriptors:
            sc, tc = int(out["src_count"]), int(out["tgt_count"])
            snc, tnc = int(out["src_node_count"]), int(out["tgt_node_count"])
            res.update(
                src_nodes=out["src_nodes"][:snc].cpu().numpy(),
                tgt_nodes=out["tgt_nodes"][:tnc].cpu().numpy(),
                src_node_desc=out["src_node_feats"][:snc].cpu().numpy(),
                tgt_node_desc=out["tgt_node_feats"][:tnc].cpu().numpy(),
                src_point_desc=out["src_point_feats"][:sc].cpu().numpy(),
                tgt_point_desc=out["tgt_point_feats"][:tc].cpu().numpy(),
            )
        return res
