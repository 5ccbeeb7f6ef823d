"""Positional and structural embeddings.

Counterpart of roitr_tpu/models/embeddings.py (reference
model/transformer/positional_encoding.py:38-154). Geometry stays fp32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from roitr_torch.kernels.geo_embedding_kernel import (
    geo_embedding,
    geo_embedding_plain,
    sinusoidal_basis,
    supported_k,
)
from roitr_torch.models.layers import Linear
from roitr_torch.ops.geometry import masked_pairwise_sq_dist, pairwise_sq_dist
from roitr_torch.ops.topk import topk

_INF = 1e10


def sinusoidal_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """indices (*,) -> (*, d_model), interleaved [sin0, cos0, sin1, cos1, ...]
    with omega_i = idx * exp(-2i log(1e4)/d) (positional_encoding.py:38-62)."""
    if d_model % 2 != 0:
        raise ValueError(f"sinusoidal embedding needs even d_model, got {d_model}")
    return sinusoidal_basis(indices, d_model)


class PPFEmbedding(nn.Module):
    """PPF embedding (reference PPFStructualEmbedding, :65-91), computing
    in `dtype` (the JAX package's `embedding_proj`); the PPF itself stays
    fp32. Local mode: one linear lift of the raw 4-d PPF. Global mode
    (models/ppf_transformer.py): a hidden_dim / 4 sinusoidal embedding of
    each PPF channel, concatenated, projected and L2-normalised."""

    def __init__(self, hidden_dim: int, dtype=torch.float32, mode: str = "local"):
        super().__init__()
        if mode not in ("local", "global"):
            raise ValueError(f"unknown PPF embedding mode {mode!r}")
        self.mode = mode
        self.proj = Linear(4 if mode == "local" else 4 * (hidden_dim // 4), hidden_dim, dtype)

    def forward(self, ppf: torch.Tensor) -> torch.Tensor:
        if self.mode == "local":
            return self.proj(ppf)
        sub = self.proj.in_features // 4
        emb = self.proj(torch.cat([sinusoidal_embedding(ppf[..., i], sub) for i in range(4)],
                                  dim=-1))
        return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True), min=1e-12)


class GeometricStructureEmbedding(nn.Module):
    """Pairwise distance + triplet angle embedding over the coarse nodes
    (reference positional_encoding.py:94-154).

    The distance and angle indices are plain torch, as in the JAX package;
    the sin/cos basis, both projections and the max over the angle_k
    neighbors run as one kernel on the card (kernels/geo_embedding_kernel.py),
    which writes the storage dtype directly; its backward is another kernel.
    More angle neighbours than the kernel takes (supported_k) run the
    plain version, through autograd, as the JAX package's XLA path does.
    The indices get no gradient (reference: computed under no_grad).
    """

    def __init__(self, hidden_dim: int, sigma_d: float = 0.2, sigma_a: float = 15.0,
                 angle_k: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.sigma_d = sigma_d
        self.sigma_a = sigma_a
        self.angle_k = angle_k
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def indices(self, points: torch.Tensor, count=None):
        """points (N, 3) prefix-packed -> d_indices (N, N), a_indices (N, N, k);
        with a leading pair axis, points (B, N, 3) and count (B,) ->
        (B, N, N), (B, N, N, k)."""
        n = points.shape[-2]
        dev = points.device
        mask = (torch.arange(n, device=dev) < torch.as_tensor(count, device=dev)[..., None]
                if count is not None else torch.ones(n, dtype=torch.bool, device=dev))
        sq = masked_pairwise_sq_dist(points, points, y_mask=mask, fill=_INF)
        d_indices = torch.sqrt(pairwise_sq_dist(points, points)) / self.sigma_d

        # clamp for tiny node sets (padded buckets can leave < angle_k + 1
        # nodes); the nearest is the row point itself
        k = max(min(self.angle_k, n - 1), 1)
        near, knn_idx = topk(sq, min(k + 1, n), dim=-1, largest=False)
        if n > 1:
            near, knn_idx = near[..., 1:], knn_idx[..., 1:]
        # padding neighbors (distance +inf) are replaced by the row point, so
        # the angle becomes atan2(0, 0) = 0 and never reads padded coordinates
        self_idx = torch.arange(n, device=dev)[:, None].expand_as(knn_idx)
        knn_idx = torch.where(near >= _INF, self_idx, knn_idx)
        if points.ndim == 2:
            knn_points = points[knn_idx]
        else:
            knn_points = points[torch.arange(points.shape[0], device=dev)[:, None, None], knn_idx]
        ref_vec = knn_points - points[..., :, None, :]  # (..., N, k, 3)
        anc_vec = points[..., None, :, :] - points[..., :, None, :]  # (..., N, N, 3)
        shape = (*points.shape[:-2], n, n, k, 3)
        r = ref_vec[..., :, None, :, :].expand(shape)
        a = anc_vec[..., :, :, None, :].expand(shape)
        sin_v = torch.linalg.norm(torch.linalg.cross(r, a, dim=-1), dim=-1)
        cos_v = torch.sum(r * a, dim=-1)
        angles = torch.atan2(sin_v, cos_v)  # (..., N, N, k)
        a_indices = angles * (180.0 / (self.sigma_a * math.pi))
        return d_indices, a_indices

    def forward(self, points: torch.Tensor, count=None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """points (..., N, 3) prefix-packed -> (..., N, N, hidden_dim) in
        out_dtype; with a pair axis all B * N * N rows go to one launch."""
        d_indices, a_indices = self.indices(points, count)
        embed = geo_embedding if supported_k(a_indices.shape[-1]) else geo_embedding_plain
        out = embed(
            d_indices.reshape(-1).contiguous(),
            a_indices.reshape(d_indices.numel(), -1).contiguous(),
            self.proj_d.weight.t(), self.proj_d.bias,
            self.proj_a.weight.t(), self.proj_a.bias,
            out_dtype,
        )
        return out.reshape(*d_indices.shape, self.hidden_dim)
