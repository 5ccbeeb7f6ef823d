"""Normal estimation on the device: PCA over the k nearest neighbours, then
the view-point flip.

Counterpart of roitr_tpu/ops/normals.py, which replaces the reference's
Open3D step (dataset/tdmatch.py:120-127: `estimate_normals(
KDTreeSearchParamKNN(knn=33))`, then `normal_redirect`,
dataset/common.py:312-320). Each point's normal is the eigenvector of the
smallest eigenvalue of its neighbourhood's covariance, flipped toward the
view point. The kNN is ops/neighbors.py's exact `masked_knn`, whose ties go
to the lower index as lax.top_k's do; the rest is elementwise 3x3 math.
The host twin is data/preprocess.py `estimate_normals_np`.
"""

from __future__ import annotations

import math

import torch

from roitr_torch.ops.geometry import prefix_mask
from roitr_torch.ops.neighbors import masked_knn


def _det3(c0, c1, c2):
    return torch.sum(c0 * torch.linalg.cross(c1, c2, dim=-1), dim=-1)


def _smallest_eigvec_3x3(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices, in closed form.

    The trigonometric form gives the eigenvalue; the largest of the cross
    products of two rows of (C - lam I) gives its vector; one step of
    inverse iteration (Cramer's rule for (C - lam' I) y = v, lam' the
    Rayleigh quotient) polishes it to about LAPACK's accuracy. An isotropic
    matrix (normal undefined) gives +z, as does a repeated smallest
    eigenvalue whose rows all cross to zero.
    """
    a, b, c = cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2]
    d, f, e = cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]
    q = (a + b + c) / 3.0
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * (d * d + f * f + e * e)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    iso = p < 1e-20
    ps = torch.where(iso, torch.ones_like(p), p)
    aq, bq, cq = (a - q) / ps, (b - q) / ps, (c - q) / ps
    dn, fn, en = d / ps, f / ps, e / ps
    detb = (aq * (bq * cq - en * en) - dn * (dn * cq - en * fn)
            + fn * (dn * en - bq * fn))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    m = cov - lam_min[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1), torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    norms2 = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms2, dim=-1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    good = torch.gather(norms2, -1, best[..., None]) > 1e-30
    z = torch.zeros_like(vec)
    z[..., 2] = 1.0
    vec = torch.where(good & ~iso[..., None], vec, z)
    vec = vec / torch.linalg.norm(vec, dim=-1, keepdim=True)

    # one inverse-iteration step: the near-singular solve's rounding error
    # grows exactly the eigencomponent wanted (det(m) cancels in the norm)
    lam = torch.einsum("...i,...ij,...j->...", vec, cov, vec)
    m = cov - lam[..., None, None] * eye
    c0, c1, c2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    y = torch.stack([_det3(vec, c1, c2), _det3(c0, vec, c2), _det3(c0, c1, vec)], dim=-1)
    ny = torch.sum(y * y, dim=-1, keepdim=True)
    ok = ny > 1e-30
    return torch.where(ok, y / torch.sqrt(torch.where(ok, ny, torch.ones_like(ny))), vec)


def _pca_normals(points, neigh, valid, slot_valid, view_point):
    """Neighbourhoods (N, k, 3) -> unit normals (N, 3) facing the view point,
    zero on invalid rows. `slot_valid` (N, k) marks real neighbour slots:
    a cloud of fewer than k points has pad rows in its trailing slots, which
    are left out, so the covariance is over min(k, count) points as on the
    host."""
    w = slot_valid[..., None].to(neigh.dtype)
    cnt = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1.0)  # (N, 1, 1)
    mean = torch.sum(neigh * w, dim=1, keepdim=True) / cnt
    centered = (neigh - mean) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt
    normals = _smallest_eigvec_3x3(cov)
    vp = torch.as_tensor(view_point, dtype=points.dtype, device=points.device)
    flip = torch.sum((vp[None, :] - points) * normals, dim=-1) < 0.0
    normals = torch.where(flip[:, None], -normals, normals)
    return torch.where(valid[:, None], normals, torch.zeros_like(normals))


def estimate_normals(points: torch.Tensor, count, k: int = 33,
                     view_point=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """points (N, 3) prefix-packed with `count` valid rows -> unit normals
    (N, 3) facing the view point, zero past `count`. The k-neighbourhood
    includes the point itself (Open3D's kNN)."""
    idx, _ = masked_knn(points, points, count, k)
    count = torch.as_tensor(count, device=points.device)
    # slots are sorted by distance, so ranks >= count are the masked pad keys
    slot_valid = torch.arange(idx.shape[1], device=points.device)[None, :] < count
    return _pca_normals(points, points[idx], prefix_mask(points.shape[0], count), slot_valid,
                        view_point)


def estimate_normals_segmented(points: torch.Tensor, counts: torch.Tensor, k: int = 33,
                               view_point=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Normals of a packed flat cloud: points (B * N, 3), B same-bucket
    clouds with counts (B,) valid rows each -> (B * N, 3), pad rows zero.
    Each segment's kNN searches its own rows only (one search batched over
    B); the neighbourhood gather is one flat row gather on segment-offset
    indices, and the PCA runs on all B * N rows at once (JAX
    roitr_tpu/ops/normals.py `estimate_normals_segmented`)."""
    b = counts.shape[0]
    n = points.shape[0] // b
    counts = counts.to(points.device)
    idx, _ = masked_knn(points.reshape(b, n, 3), points.reshape(b, n, 3), counts, k)
    offset = (torch.arange(b, device=points.device) * n)[:, None, None]
    flat_idx = (idx + offset).reshape(b * n, -1)
    kk = idx.shape[-1]
    slot_valid = (torch.arange(kk, device=points.device)[None, None, :]
                  < counts[:, None, None]).expand(b, n, kk).reshape(b * n, kk)
    return _pca_normals(points, points[flat_idx], prefix_mask(points.shape[0], counts),
                        slot_valid, view_point)
