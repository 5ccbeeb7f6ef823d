"""Correspondence RANSAC on a card (every hypothesis of a pair at once).

Counterpart of roitr_tpu/eval/ransac_jax.py, with the semantics of
eval/ransac.py (the numpy port of Open3D's
registration_ransac_based_on_correspondence, reference
registration/benchmark_utils.py:165-209): 3-point hypotheses, the
edge-length and distance checkers, the inlier count ranking with the RMSE
breaking ties, and the final fit on the winner's inliers.

- The hypotheses' indices are drawn on the host from the numpy backend's
  `np.random.RandomState` stream, in one (iterations, 3) draw, and copied
  to the device once.
- Each rotation is Horn's: the dominant eigenvector of the 4x4 form of the
  centred triplets' correlation, by 40 shifted power-iteration steps
  (exactly orthonormal, built from a unit quaternion).
- Inliers are counted over every correspondence, for the hypotheses that
  pass both checkers (the others rank last), in chunks of `chunk`
  hypotheses, so that the (H, N) distances never exist at full H.
- The winner has the largest count, then the least RMSE, the earliest
  hypothesis on exact ties: a max, then a first argmin, never a combined
  score (count - rmse inverts across counts when the threshold is >= 1).
- The fit on the winner's inliers is the numpy backend's fp64 Kabsch, on
  the host.

Every product is an elementwise fp32 product: no matrix product, so no
TF32 on a card, and the same rounding on the card as on the CPU, where the
inlier test cannot move a point across the threshold. The RMSE sums
accumulate in fp64, so that the order of a reduction cannot swap two
hypotheses of near-equal RMSE. The correspondences are not padded (eager
PyTorch compiles nothing per shape, unlike XLA).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from roitr_torch.eval.ransac import kabsch

POWER_STEPS = 40


def _dot3(a, b) -> torch.Tensor:
    """a0 b0 + a1 b1 + a2 b2 over the last axis, in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def horn_rotation(s0: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """(H, 3, 3) centred triplets (points on axis 1) -> (H, 3, 3) rotations
    R with R s ~ t (Horn's convention, S = sum_m s_m (x) t_m)."""
    s = [[_dot3(s0[:, :, a], t0[:, :, c]) for c in range(3)] for a in range(3)]
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = s
    rows = ((sxx + syy + szz, syz - szy, szx - sxz, sxy - syx),
            (syz - szy, sxx - syy - szz, sxy + syx, szx + sxz),
            (szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy),
            (sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz))
    nmat = torch.stack([torch.stack(r, -1) for r in rows], -2)  # (H, 4, 4)
    # shift so that the largest eigenvalue is also the largest in magnitude:
    # |lambda| <= 2 sum_m |s_m| |t_m|
    norms = torch.sqrt(_dot3(s0, s0)) * torch.sqrt(_dot3(t0, t0))  # (H, 3)
    bound = 2.0 * (norms[:, 0] + norms[:, 1] + norms[:, 2])
    nmat = nmat + (bound + 1e-6)[:, None, None] * torch.eye(4, dtype=s0.dtype, device=s0.device)
    q = torch.zeros(nmat.shape[0], 4, dtype=s0.dtype, device=s0.device)
    q[:, 0] = 1.0
    for _ in range(POWER_STEPS):
        p = nmat * q[:, None, :]
        q = p[..., 0] + p[..., 1] + p[..., 2] + p[..., 3]
        qq = q * q
        norm = torch.sqrt(qq[:, 0] + qq[:, 1] + qq[:, 2] + qq[:, 3]).clamp(min=1e-30)
        q = q / norm[:, None]
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z], -1),
    ], -2)


def _apply(r: torch.Tensor, t: torch.Tensor, pts: torch.Tensor, i: int) -> torch.Tensor:
    """Coordinate i of R p + t, elementwise in a fixed order: r (C, 3, 3), t
    (C, 3) against pts (N, 3) -> (C, N), or against each hypothesis' own
    points pts (C, K, 3) -> (C, K)."""
    return (r[:, i, 0, None] * pts[..., 0] + r[:, i, 1, None] * pts[..., 1]
            + r[:, i, 2, None] * pts[..., 2] + t[:, i, None])


def best_hypothesis(src: torch.Tensor, tgt: torch.Tensor, idx: torch.Tensor,
                    distance_threshold: float, edge_length_ratio: float = 0.9,
                    chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """The winning hypothesis of `idx` (H, 3) over the correspondences src,
    tgt (N, 3) fp32, on their device: (R (3, 3), t (3,), inlier count,
    hypothesis index). The count is -1 when every hypothesis fails a
    checker."""
    thr, ratio = float(distance_threshold), float(edge_length_ratio)
    s_tri, t_tri = src[idx], tgt[idx]  # (H, 3, 3): hypothesis, point, axis
    ok = torch.ones(idx.shape[0], dtype=torch.bool, device=src.device)
    for i, j in ((0, 1), (1, 2), (0, 2)):
        ds, dt = s_tri[:, i] - s_tri[:, j], t_tri[:, i] - t_tri[:, j]
        ls, lt = torch.sqrt(_dot3(ds, ds)), torch.sqrt(_dot3(dt, dt))
        ok &= (ls > ratio * lt) & (lt > ratio * ls)
    s_c = (s_tri[:, 0] + s_tri[:, 1] + s_tri[:, 2]) / 3
    t_c = (t_tri[:, 0] + t_tri[:, 1] + t_tri[:, 2]) / 3
    r = horn_rotation(s_tri - s_c[:, None], t_tri - t_c[:, None])
    t = t_c - torch.stack([_dot3(r[:, i], s_c) for i in range(3)], -1)
    # the distance checker on the sampled triplet
    res = [_apply(r, t, s_tri, i) - t_tri[..., i] for i in range(3)]  # (H, 3) each
    ok &= (torch.sqrt(res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) < thr).all(-1)

    # only the hypotheses that pass both checkers are counted (the others
    # rank below every count), in their order
    keep = ok.nonzero().squeeze(1)
    count = torch.full((idx.shape[0],), -1, dtype=torch.int64, device=src.device)
    rmse = torch.zeros(idx.shape[0], dtype=torch.float64, device=src.device)
    for a in range(0, keep.numel(), chunk):
        sel = keep[a:a + chunk]
        rc, tc = r[sel], t[sel]
        d2 = None
        for i in range(3):
            d = _apply(rc, tc, src, i)
            d -= tgt[:, i]
            d2 = d * d if d2 is None else d2.add_(d.mul_(d))
        inl = d2 < thr * thr
        count[sel] = inl.sum(-1)
        rmse[sel] = torch.sqrt(torch.where(inl, d2, 0.0).sum(-1, dtype=torch.float64)
                               / count[sel].clamp(min=1))
    best_count = count.max()
    best = torch.argmin(torch.where(count == best_count, rmse, torch.inf))  # the first minimum
    return r[best], t[best], int(best_count), int(best)


def ransac_pose_estimation_correspondences_torch(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    correspondences: Optional[np.ndarray] = None,
    distance_threshold: float = 0.05,
    ransac_n: int = 3,
    max_iterations: int = 50000,
    edge_length_ratio: float = 0.9,
    seed: Optional[int] = None,
    chunk: int = 4096,
    device="cuda",
) -> np.ndarray:
    """eval/ransac.py's ransac_pose_estimation_correspondences with its
    hypotheses on `device` (the card by default; "cpu" when asked): a
    (4, 4) transform src -> tgt. The full budget always runs, as the
    reference protocol's does (no `confidence` early stop); identity for
    fewer than 3 correspondences or when every hypothesis fails the
    checkers."""
    if ransac_n != 3:
        raise NotImplementedError("the torch backend implements ransac_n=3")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for but no CUDA device is available; pass "
                           "device='cpu'")
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
    idx = rng.randint(0, n, size=(max_iterations, ransac_n))
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    r, t, count, _ = best_hypothesis(to(src_pts.astype(np.float32)),
                                     to(tgt_pts.astype(np.float32)), to(idx),
                                     distance_threshold, edge_length_ratio, chunk)
    if count < 0:
        return eye
    r = r.cpu().numpy().astype(np.float64)
    t = t.cpu().numpy().astype(np.float64)

    # the fit on the winner's inliers, fp64 on the host (the numpy backend's)
    s_all = src_pts @ r.T + t
    inl = np.linalg.norm(s_all - tgt_pts, axis=-1) < distance_threshold
    if inl.sum() >= ransac_n:
        r, t = kabsch(src_pts[inl], tgt_pts[inl])
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out
