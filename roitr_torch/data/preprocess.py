"""Host-side preprocessing: cap, augmentation, normals and bucketed
padding (numpy/scipy), and the host pyramids (data/pyramid.py).

Counterpart of roitr_tpu/data/preprocess.py (reference
dataset/tdmatch.py:50-135: load -> cap 30k -> random SO(3) augment ->
kNN-33 normals -> redirect). Normals come from the scipy cKDTree + PCA
path; the JAX package uses its native C++ KD-tree instead whenever that is
built, so tests hand both packages the same normals or turn the native
tree off.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def _rotate_one_side(rng: np.random.RandomState, src_pcd, tgt_pcd, rot, trans,
                     rot_factor: float):
    """A random rotation (zyx Euler angles from `rng`) applied to one side
    picked by `rng`, the GT fixed up to match. Returns copies."""
    from scipy.spatial.transform import Rotation

    euler = rng.rand(3) * 2.0 * np.pi / rot_factor
    rot_ab = Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)
    src_pcd, tgt_pcd = src_pcd.copy(), tgt_pcd.copy()
    if rng.rand(1)[0] > 0.5:
        src_pcd = src_pcd @ rot_ab.T
        rot = rot @ rot_ab.T
    else:
        tgt_pcd = tgt_pcd @ rot_ab.T
        rot = rot_ab @ rot
        trans = rot_ab @ trans
    return src_pcd, tgt_pcd, rot.astype(np.float32), trans.astype(np.float32)


def random_so3_augment(rng: np.random.RandomState, src_pcd: np.ndarray, tgt_pcd: np.ndarray,
                       rot: np.ndarray, trans: np.ndarray, noise: float,
                       rot_factor: float = 1.0):
    """Random full-SO(3) rotation of one side, the GT fixed up to match, and
    uniform noise on both (reference dataset/tdmatch.py:82-97). Returns
    copies."""
    src_pcd, tgt_pcd, rot, trans = _rotate_one_side(rng, src_pcd, tgt_pcd, rot, trans,
                                                    rot_factor)
    src_pcd = src_pcd + (rng.rand(*src_pcd.shape).astype(np.float32) - 0.5) * noise
    tgt_pcd = tgt_pcd + (rng.rand(*tgt_pcd.shape).astype(np.float32) - 0.5) * noise
    return src_pcd, tgt_pcd, rot, trans


def seeded_so3_rotation(index: int, src_pcd, tgt_pcd, rot, trans, rot_factor: float = 1.0):
    """Deterministic rotation of pair `index` for the rotated benchmarks
    (reference dataset/tdmatch.py:99-112)."""
    return _rotate_one_side(np.random.RandomState(index), src_pcd, tgt_pcd, rot, trans,
                            rot_factor)


def cap_points(rng: np.random.RandomState, pcd: np.ndarray, limit: int) -> np.ndarray:
    """Random subset down to the point cap (reference dataset/tdmatch.py:72-78)."""
    if pcd.shape[0] > limit:
        return pcd[rng.permutation(pcd.shape[0])[:limit]]
    return pcd


def preprocess_pair(rng: np.random.RandomState, src_pcd: np.ndarray, tgt_pcd: np.ndarray,
                    rot: np.ndarray, trans: np.ndarray, buckets: Sequence[int],
                    points_limit: int = 30000, augment: bool = False,
                    augment_noise: float = 0.005, rotated_index: Optional[int] = None,
                    normal_knn: int = 33, view_point=(0.0, 0.0, 0.0),
                    src_raw_pcd: Optional[np.ndarray] = None,
                    metric_index: Optional[np.ndarray] = None, build_pyramid: bool = False,
                    device_prep: bool = False) -> Dict[str, np.ndarray]:
    """One pair through the host pipeline -> dict of padded numpy arrays.

    `src_raw_pcd`: the raw source geometry when `src_pcd` is a deformed
    cloud (4DMatch); defaults to `src_pcd`. `device_prep=True` ships zero
    normals, which ops/pyramid.py `device_prep_pair` replaces on the device
    before the model reads them. `build_pyramid` adds both clouds' host
    pyramids (data/pyramid.py, default strides and nsample) under
    "src_pyramid" / "tgt_pyramid", unless `device_prep`, which builds them
    on the device.
    """
    if trans.ndim == 1:
        trans = trans[:, None]
    src_pcd = cap_points(rng, src_pcd, points_limit)
    tgt_pcd = cap_points(rng, tgt_pcd, points_limit)
    if augment:
        src_pcd, tgt_pcd, rot, trans = random_so3_augment(rng, src_pcd, tgt_pcd, rot, trans,
                                                          augment_noise)
    elif rotated_index is not None:
        src_pcd, tgt_pcd, rot, trans = seeded_so3_rotation(rotated_index, src_pcd, tgt_pcd, rot,
                                                           trans)
    if src_raw_pcd is None:
        src_raw_pcd = src_pcd

    if device_prep:
        src_normals = np.zeros_like(src_raw_pcd)
        tgt_normals = np.zeros_like(tgt_pcd)
    else:
        src_normals = normal_redirect_np(src_raw_pcd, estimate_normals_np(src_raw_pcd, normal_knn),
                                         view_point)
        tgt_normals = normal_redirect_np(tgt_pcd, estimate_normals_np(tgt_pcd, normal_knn),
                                         view_point)

    bucket = pick_bucket(max(src_pcd.shape[0], tgt_pcd.shape[0]), buckets)
    s_pts, s_nrm, s_feats, s_cnt = pad_cloud(src_pcd, src_normals, bucket)
    t_pts, t_nrm, t_feats, t_cnt = pad_cloud(tgt_pcd, tgt_normals, bucket)
    raw_pts = np.zeros((bucket, 3), np.float32)
    raw_pts[: src_raw_pcd.shape[0]] = src_raw_pcd
    out = {
        "src_points": s_pts, "src_raw_points": raw_pts, "src_normals": s_nrm,
        "src_feats": s_feats, "src_count": s_cnt,
        "tgt_points": t_pts, "tgt_normals": t_nrm, "tgt_feats": t_feats, "tgt_count": t_cnt,
        "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
    }
    if metric_index is not None:
        out["metric_index"] = metric_index
    if build_pyramid and not device_prep:
        from roitr_torch.data.pyramid import build_cloud_pyramid

        # the backbone's pyramid is built on the raw source geometry
        # (reference RIGA_v2.py:62 runs the backbone on src_raw_pcd)
        out["src_pyramid"] = build_cloud_pyramid(raw_pts, s_cnt)
        out["tgt_pyramid"] = build_cloud_pyramid(t_pts, t_cnt)
    return out
