"""3DMatch / 3DLoMatch pair dataset (host side).

Counterpart of roitr_tpu/data/tdmatch.py. Reads the reference's data layout
unchanged (reference dataset/tdmatch.py:50-135): an info pickle with
'rot' / 'trans' / 'src' / 'tgt' / 'overlap' lists and one `.pth` tensor a
fragment under the data root, so existing downloads work as they are.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from roitr_torch.config import Config
from roitr_torch.data.preprocess import preprocess_pair


def load_info(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _load_cloud(path: str) -> np.ndarray:
    """A point array as the reference tooling saves it (.pth), or converted
    (.npz with a 'points' entry, .npy)."""
    if path.endswith(".pth"):
        data = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(data, torch.Tensor):
            data = data.numpy()
        return np.asarray(data, np.float32)
    if path.endswith(".npz"):
        return np.load(path)["points"].astype(np.float32)
    return np.load(path).astype(np.float32)


class TDMatchDataset:
    """Preprocessed, padded 3DMatch pairs by index."""

    # the reference skips one corrupt fragment (dataset/tdmatch.py:59-65)
    _BAD = ("7-scenes-fire", "cloud_bin_19.pth")

    def __init__(self, infos: Dict, config: Config, data_augmentation: bool = True):
        self.infos = infos
        self.base_dir = config.root
        self.config = config
        self.data_augmentation = data_augmentation
        self.rotated = config.rotated
        self.view_point = np.array([0.0, 0.0, 0.0])

    def __len__(self) -> int:
        return len(self.infos["rot"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        src_path = os.path.join(self.base_dir, self.infos["src"][index])
        if tuple(src_path.split("/")[-2:]) == self._BAD:
            index = (index + 1) % len(self)
            src_path = os.path.join(self.base_dir, self.infos["src"][index])
        rot = np.asarray(self.infos["rot"][index], np.float32)
        trans = np.asarray(self.infos["trans"][index], np.float32)
        tgt_path = os.path.join(self.base_dir, self.infos["tgt"][index])
        # augmented pairs draw fresh randomness; the others are seeded by
        # index so a split reads the same every time
        rng = np.random.RandomState() if self.data_augmentation else np.random.RandomState(index)
        cfg = self.config
        return preprocess_pair(
            rng, _load_cloud(src_path), _load_cloud(tgt_path), rot, trans,
            buckets=cfg.buckets, points_limit=cfg.points_limit, augment=self.data_augmentation,
            augment_noise=cfg.augment_noise,
            rotated_index=index if (self.rotated and not self.data_augmentation) else None,
            normal_knn=cfg.normal_knn, view_point=self.view_point,
            build_pyramid=cfg.host_pyramid, device_prep=cfg.device_prep)
