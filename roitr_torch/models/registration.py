"""Local-to-global registration (GeoTransformer's LocalGlobalRegistration),
on the device over fixed-size correspondence buffers. Nothing here reads
back to the host, but `torch.linalg.svd` on the card may wait on its
solver: two SVD calls for the start, then one a refinement round.

The correspondences are fine matching's (P * L) rows, patch-major, each
with a score (zero where the row is masked). Each patch with at least
`min_corr` correspondences gives a hypothesis, the weighted Procrustes of
its own rows; the hypothesis with the most inliers (residual below
`acceptance_radius`) over every correspondence wins (the first of equal
counts). With no such patch, the Procrustes of every correspondence is
the start. Then `steps` rounds: the weights become the scores times the
current transform's inlier mask, and Procrustes gives the next transform.
"""

from __future__ import annotations

import torch


def weighted_procrustes(src: torch.Tensor, ref: torch.Tensor, weights: torch.Tensor,
                        eps: float = 1e-5):
    """Batched weighted Kabsch (GeoTransformer's WeightedProcrustes):
    src, ref (B, C, 3), weights (B, C) -> R (B, 3, 3), t (B, 3) with
    ref ~ src @ R^T + t. Weights are divided by their sum plus eps; the SVD
    of H = sum w (src - c_s)(ref - c_r)^T gives R = V diag(1, 1, det(V U^T))
    U^T."""
    w = weights * (weights > 0.0)
    w = (w / (w.sum(dim=1, keepdim=True) + eps))[..., None]
    cs = (src * w).sum(dim=1, keepdim=True)
    cr = (ref * w).sum(dim=1, keepdim=True)
    h = (src - cs).transpose(1, 2) @ (w * (ref - cr))
    u, _, vh = torch.linalg.svd(h)
    v, ut = vh.transpose(1, 2), u.transpose(1, 2)
    d = torch.ones((h.shape[0], 3), dtype=h.dtype, device=h.device)
    m = v @ ut  # orthogonal: its determinant is +-1, by a triple product
    d[:, 2] = torch.sign(torch.sum(m[:, 0] * torch.linalg.cross(m[:, 1], m[:, 2], dim=-1), -1))
    rot = v @ torch.diag_embed(d) @ ut
    trans = cr[:, 0] - (rot @ cs.transpose(1, 2))[..., 0]
    return rot, trans


def inliers(ref: torch.Tensor, src: torch.Tensor, masks: torch.Tensor, rot: torch.Tensor,
            trans: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, C) bool: each valid correspondence whose source point, moved by
    each of the B transforms, lies within `radius` of its reference point."""
    moved = torch.einsum("bij,cj->bci", rot, src) + trans[:, None, :]
    return (torch.linalg.norm(ref[None] - moved, dim=-1) < radius) & masks[None]


def local_to_global_registration(ref: torch.Tensor, src: torch.Tensor, scores: torch.Tensor,
                                 masks: torch.Tensor, patches: int, min_corr: int = 3,
                                 acceptance_radius: float = 0.1, steps: int = 5):
    """ref, src (P * L, 3) correspondences patch-major, scores and masks
    (P * L,) -> (4, 4) transform taking the source onto the reference."""
    scores = torch.where(masks, scores, torch.zeros_like(scores))
    local = weighted_procrustes(src.reshape(patches, -1, 3), ref.reshape(patches, -1, 3),
                                scores.reshape(patches, -1))
    whole = weighted_procrustes(src[None], ref[None], scores[None])
    rot, trans = torch.cat([local[0], whole[0]]), torch.cat([local[1], whole[1]])
    ok = masks.reshape(patches, -1).sum(dim=1) >= min_corr
    counts = inliers(ref, src, masks, rot[:-1], trans[:-1], acceptance_radius).sum(dim=1)
    counts = torch.where(ok, counts, torch.full_like(counts, -1))
    best = torch.where(ok.any(), torch.argmax(counts), patches)  # the whole set's: row P
    rot, trans = rot[best][None], trans[best][None]
    for _ in range(steps):
        weights = scores * inliers(ref, src, masks, rot, trans, acceptance_radius)[0]
        rot, trans = weighted_procrustes(src[None], ref[None], weights[None])
    out = torch.eye(4, dtype=ref.dtype, device=ref.device)
    out[:3, :3] = rot[0]
    out[:3, 3] = trans[0]
    return out
