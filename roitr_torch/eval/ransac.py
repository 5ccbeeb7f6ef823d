"""Correspondence-based RANSAC rigid pose estimation (vectorized numpy).

The port's own copy of roitr_tpu/eval/ransac.py (numpy, function for
function); eval/ransac_torch.py runs the same hypotheses on a card.
Replaces Open3D's registration_ransac_based_on_correspondence (reference
registration/benchmark_utils.py:165-209) — Open3D is not a dependency of
this framework. Semantics follow the Open3D pipeline:

- ransac_n=3 correspondences per hypothesis, point-to-point Kabsch (no
  scaling),
- CorrespondenceCheckerBasedOnEdgeLength(0.9): the triplet's pairwise edge
  lengths must agree between clouds within ratio 0.9 (both directions),
- CorrespondenceCheckerBasedOnDistance(threshold): the sampled pairs must
  align within the distance threshold under the hypothesis,
- hypotheses ranked by inlier count (ties: lower RMSE), 50k iterations,
- final transform re-estimated on the best hypothesis's inliers.

Everything is vectorized over hypotheses in chunks — 50k hypotheses against
5k correspondences evaluate in well under a second.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kabsch(src: np.ndarray, tgt: np.ndarray, weights: Optional[np.ndarray] = None):
    """Batched rigid alignment src -> tgt. src/tgt: (..., M, 3)."""
    if weights is None:
        w = np.ones(src.shape[:-1], src.dtype)
    else:
        w = weights
    wsum = np.clip(w.sum(-1, keepdims=True), 1e-12, None)
    src_c = (src * w[..., None]).sum(-2, keepdims=True) / wsum[..., None]
    tgt_c = (tgt * w[..., None]).sum(-2, keepdims=True) / wsum[..., None]
    s0, t0 = src - src_c, tgt - tgt_c
    h = np.einsum("...mi,...m,...mj->...ij", s0, w, t0)
    u, _, vt = np.linalg.svd(h)
    v = np.swapaxes(vt, -1, -2)
    ut = np.swapaxes(u, -1, -2)
    det = np.linalg.det(v @ ut)
    d = np.ones(det.shape + (3,), src.dtype)
    d[..., 2] = np.sign(det)
    r = v @ (d[..., :, None] * ut)
    t = np.squeeze(np.swapaxes(tgt_c, -1, -2) - r @ np.swapaxes(src_c, -1, -2), -1)
    return r, t


def _edge_length_ok(src_tri: np.ndarray, tgt_tri: np.ndarray, ratio: float) -> np.ndarray:
    """(B, 3, 3) triplets -> (B,) bool edge-length compatibility."""
    pairs = [(0, 1), (1, 2), (0, 2)]
    ok = np.ones(src_tri.shape[0], bool)
    for i, j in pairs:
        ls = np.linalg.norm(src_tri[:, i] - src_tri[:, j], axis=-1)
        lt = np.linalg.norm(tgt_tri[:, i] - tgt_tri[:, j], axis=-1)
        ok &= (ls > ratio * lt) & (lt > ratio * ls)
    return ok


def ransac_pose_estimation_correspondences(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    correspondences: Optional[np.ndarray] = None,
    distance_threshold: float = 0.05,
    ransac_n: int = 3,
    max_iterations: int = 50000,
    edge_length_ratio: float = 0.9,
    seed: Optional[int] = None,
    chunk: int = 4096,
    confidence: Optional[float] = None,
) -> np.ndarray:
    """Returns a (4, 4) transformation src -> tgt.

    `confidence` (e.g. 0.999) enables Open3D-style early termination: stop
    once enough hypotheses were drawn that, at the current best inlier
    ratio, an all-inlier sample was seen with this probability
    (k = log(1-conf) / log(1-w^ransac_n)). None (default) runs the full
    budget — exact reference-protocol parity (the reference's criteria
    `(50000, 1000)` is max_iteration/max_validation, no early stop)."""
    src_pts = np.asarray(src_pts, np.float64)
    tgt_pts = np.asarray(tgt_pts, np.float64)
    if correspondences is not None:
        correspondences = np.asarray(correspondences)
        src_pts = src_pts[correspondences[:, 0]]
        tgt_pts = tgt_pts[correspondences[:, 1]]
    n = src_pts.shape[0]
    eye = np.eye(4)
    if n < ransac_n:
        return eye

    rng = np.random.RandomState(seed)
    best_count = -1
    best_rmse = np.inf
    best_rt: Optional[Tuple[np.ndarray, np.ndarray]] = None

    for start in range(0, max_iterations, chunk):
        b = min(chunk, max_iterations - start)
        idx = rng.randint(0, n, size=(b, ransac_n))
        s_tri = src_pts[idx]  # (b, 3, 3)
        t_tri = tgt_pts[idx]

        ok = _edge_length_ok(s_tri, t_tri, edge_length_ratio)
        if not ok.any():
            continue
        s_ok, t_ok = s_tri[ok], t_tri[ok]
        r, t = kabsch(s_ok, t_ok)

        # distance checker on the sampled triplet
        s_tr = np.einsum("bij,bkj->bki", r, s_ok) + t[:, None, :]
        tri_ok = (np.linalg.norm(s_tr - t_ok, axis=-1) < distance_threshold).all(-1)
        if not tri_ok.any():
            continue
        r, t = r[tri_ok], t[tri_ok]

        # inlier counting over all correspondences
        s_all = np.einsum("bij,nj->bni", r, src_pts) + t[:, None, :]
        d = np.linalg.norm(s_all - tgt_pts[None], axis=-1)  # (b', n)
        inl = d < distance_threshold
        counts = inl.sum(-1)
        rmse = np.sqrt((np.where(inl, d, 0.0) ** 2).sum(-1) / np.clip(counts, 1, None))
        order = np.lexsort((rmse, -counts))
        cand = order[0]
        if counts[cand] > best_count or (
            counts[cand] == best_count and rmse[cand] < best_rmse
        ):
            best_count = int(counts[cand])
            best_rmse = float(rmse[cand])
            best_rt = (r[cand], t[cand])

        if confidence is not None and 0 < best_count:
            w = best_count / n
            denom = np.log1p(-min(w**ransac_n, 1 - 1e-12))
            needed = np.log1p(-confidence) / denom if denom < 0 else np.inf
            if start + b >= needed:
                break

    if best_rt is None:
        return eye

    # refine on final inliers
    r, t = best_rt
    s_all = src_pts @ r.T + t
    inl = np.linalg.norm(s_all - tgt_pts, axis=-1) < distance_threshold
    if inl.sum() >= ransac_n:
        r, t = kabsch(src_pts[inl], tgt_pts[inl])
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def get_inlier_ratio_correspondence(
    src_corr: np.ndarray, tgt_corr: np.ndarray, rot: np.ndarray, trans: np.ndarray,
    inlier_distance_threshold: float = 0.1,
) -> float:
    """Fraction of correspondences within threshold under the GT transform
    (reference benchmark_utils.py:69-77 style)."""
    if src_corr.shape[0] == 0:
        return 0.0
    src_t = src_corr @ np.asarray(rot).T + np.asarray(trans).reshape(1, 3)
    d = np.linalg.norm(src_t - tgt_corr, axis=1)
    return float((d < inlier_distance_threshold).mean())
