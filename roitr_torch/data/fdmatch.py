"""4DMatch / 4DLoMatch non-rigid pair dataset (host side).

Counterpart of roitr_tpu/data/fdmatch.py. Reads the reference's `.npz`
entries unchanged (reference dataset/fdmatch.py:31-98): s_pc, t_pc,
s2t_flow, rot, trans and, on the test splits, metric_index. The deformed
source (s_pc + s2t_flow) is the matching geometry; the raw source carries
the normals and the backbone.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from roitr_torch.config import Config
from roitr_torch.data.preprocess import (
    cap_points,
    estimate_normals_np,
    normal_redirect_np,
    pad_cloud,
    pick_bucket,
)


def read_entries(split: str, data_root: str) -> List[str]:
    """A 4DMatch split -> its sorted list of `.npz` entry paths.

    As the reference (lib/utils.py:11-25): `split` is a directory under the
    data root (e.g. 'split/4DMatch' of Lepard's layout), globbed as
    <split>/*/*.npz (sorted here, so pair indices do not follow the file
    system's order). A text file of `.npz` paths relative to the data root,
    one a line, works too."""
    path = split if os.path.isabs(split) else os.path.join(data_root, split)
    if os.path.isdir(path):
        entries = sorted(glob.glob(os.path.join(path, "*", "*.npz")))
        if not entries:
            raise FileNotFoundError(
                f"4DMatch split directory {path!r} holds no <scene>/*.npz entries: expected "
                "the Lepard layout (split/<benchmark>/<scene>/<pair>.npz)")
        return entries
    split_file = split if os.path.exists(split) else path
    with open(split_file) as f:
        return [os.path.join(data_root, line.strip()) for line in f if line.strip()]


class FDMatchDataset:
    """Preprocessed, padded non-rigid pairs by index, as data/tdmatch.py's
    items plus `metric_index` where the entry has one. Augmented pairs
    (training) draw fresh randomness; the others are seeded by index."""

    def __init__(self, entries: List[str], config: Config, data_augmentation: bool = True):
        self.entries = entries
        self.config = config
        self.data_augmentation = data_augmentation
        self.view_point = np.array([0.0, 0.0, 0.0])

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        from scipy.spatial.transform import Rotation

        cfg = self.config
        entry = np.load(self.entries[index])
        rot = entry["rot"].astype(np.float32)
        trans = entry["trans"].astype(np.float32)
        src_pcd = entry["s_pc"].astype(np.float32)
        tgt_pcd = entry["t_pc"].astype(np.float32)
        src_deformed = (src_pcd + entry["s2t_flow"]).astype(np.float32)
        metric_index = (entry["metric_index"].squeeze().astype(np.int32)
                        if "metric_index" in entry else None)

        rng = np.random.RandomState() if self.data_augmentation else np.random.RandomState(index)
        if src_pcd.shape[0] > cfg.points_limit:  # one subset for both source copies
            idx = rng.permutation(src_pcd.shape[0])[:cfg.points_limit]
            src_pcd, src_deformed = src_pcd[idx], src_deformed[idx]
        tgt_pcd = cap_points(rng, tgt_pcd, cfg.points_limit)

        if self.data_augmentation:
            # one side rotated, then noise on the raw source and the target,
            # never on the deformed copy (reference fdmatch.py:59-73)
            euler = rng.rand(3) * 2.0 * np.pi
            rot_ab = Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)
            if rng.rand(1)[0] > 0.5:
                src_pcd = src_pcd @ rot_ab.T
                src_deformed = src_deformed @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                tgt_pcd = tgt_pcd @ rot_ab.T
                rot = rot_ab @ rot
                trans = rot_ab @ trans
            src_pcd = src_pcd + (rng.rand(*src_pcd.shape).astype(np.float32) - 0.5) \
                * cfg.augment_noise
            tgt_pcd = tgt_pcd + (rng.rand(*tgt_pcd.shape).astype(np.float32) - 0.5) \
                * cfg.augment_noise
        if trans.ndim == 1:
            trans = trans[:, None]

        if cfg.device_prep:  # ops/pyramid.py device_prep_pair estimates them
            src_normals, tgt_normals = np.zeros_like(src_pcd), np.zeros_like(tgt_pcd)
        else:
            src_normals = normal_redirect_np(
                src_pcd, estimate_normals_np(src_pcd, cfg.normal_knn), self.view_point)
            tgt_normals = normal_redirect_np(
                tgt_pcd, estimate_normals_np(tgt_pcd, cfg.normal_knn), self.view_point)

        bucket = pick_bucket(max(src_pcd.shape[0], tgt_pcd.shape[0]), cfg.buckets)
        s_pts, s_nrm, s_feats, s_cnt = pad_cloud(src_deformed, src_normals, bucket)
        t_pts, t_nrm, t_feats, t_cnt = pad_cloud(tgt_pcd, tgt_normals, bucket)
        raw = np.zeros((bucket, 3), np.float32)
        raw[:src_pcd.shape[0]] = src_pcd
        out = {
            "src_points": s_pts, "src_raw_points": raw, "src_normals": s_nrm,
            "src_feats": s_feats, "src_count": s_cnt,
            "tgt_points": t_pts, "tgt_normals": t_nrm, "tgt_feats": t_feats, "tgt_count": t_cnt,
            "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
        }
        if metric_index is not None:
            out["metric_index"] = metric_index
        if cfg.host_pyramid and not cfg.device_prep:
            from roitr_torch.data.pyramid import build_cloud_pyramid

            # the backbone runs on the raw source (reference RIGA_v2.py:62)
            out["src_pyramid"] = build_cloud_pyramid(raw, s_cnt)
            out["tgt_pyramid"] = build_cloud_pyramid(t_pts, t_cnt)
        return out
