"""Host-side preprocessing: normals and bucketed padding (numpy/scipy).

Counterpart of roitr_tpu/data/preprocess.py (reference
dataset/tdmatch.py:50-135). Normals come from the scipy cKDTree + PCA
path; the JAX package uses its native C++ KD-tree instead whenever that is
built, so tests hand both packages the same normals.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.spatial import cKDTree


def estimate_normals_np(points: np.ndarray, k: int = 33) -> np.ndarray:
    """PCA normals over the k-neighborhood (incl. self), unoriented: the
    smallest-eigenvalue eigenvector of the neighborhood covariance (Open3D
    estimate_normals(KDTreeSearchParamKNN(knn=k)) up to sign)."""
    n = points.shape[0]
    k = min(k, n)
    _, idx = cKDTree(points).query(points, k=k)
    if k == 1:
        idx = idx[:, None]
    neigh = points[idx]  # (N, k, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[..., 0]
    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.clip(norms, 1e-12, None)).astype(np.float32)


def normal_redirect_np(points: np.ndarray, normals: np.ndarray, view_point) -> np.ndarray:
    """Flip normals toward the view point (reference dataset/common.py:312-320)."""
    vp = np.asarray(view_point, np.float32)
    flip = np.sum((vp - points) * normals, axis=-1) < 0.0
    out = normals.copy()
    out[flip] *= -1.0
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket (multiple of 64) holding n points."""
    for b in sorted(buckets):
        if n <= b:
            return b
    return sorted(buckets)[-1]


def pad_cloud(pcd: np.ndarray, normals: np.ndarray, bucket: int):
    """Prefix-pack into the bucket; returns (points, normals, feats, count)."""
    n = pcd.shape[0]
    pts = np.zeros((bucket, 3), np.float32)
    nrm = np.zeros((bucket, 3), np.float32)
    pts[:n] = pcd
    nrm[:n] = normals
    feats = np.ones((bucket, 1), np.float32)
    return pts, nrm, feats, np.int32(n)
