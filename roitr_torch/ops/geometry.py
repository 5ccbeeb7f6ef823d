"""Core rotation-invariant geometry primitives on padded clouds (torch).

Counterpart of roitr_tpu/ops/geometry.py. A cloud is an `(N, 3)` tensor
whose first `count` rows are valid; counts and masks keep every shape
fixed per bucket.
"""

from __future__ import annotations

import math

import torch

_INF = 1e10


def prefix_mask(n: int, count, device=None) -> torch.Tensor:
    """Boolean validity mask (n,) for a prefix-packed axis of length n."""
    count = torch.as_tensor(count, device=device)
    return torch.arange(n, device=count.device) < count


def index_valid(idx: torch.Tensor, count) -> torch.Tensor:
    """Validity of row indices into a prefix-packed axis: idx < count."""
    return idx < torch.as_tensor(count, device=idx.device)


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Squared Euclidean distances between all row pairs.

    x: (..., N, C), y: (..., M, C) -> (..., N, M), in the x^2 - 2xy + y^2
    form of reference lib/utils.py:139-156 with its 1e-12 clamp. The product
    runs in full fp32: callers on the card keep TF32 off
    (`torch.backends.cuda.matmul.allow_tf32 = False`).
    """
    xy = torch.matmul(x, y.transpose(-1, -2))
    if normalized:
        d2 = 2.0 - 2.0 * xy
    else:
        x2 = torch.sum(x * x, dim=-1)[..., :, None]
        y2 = torch.sum(y * y, dim=-1)[..., None, :]
        d2 = x2 - 2.0 * xy + y2
    return torch.clamp(d2, min=1e-12)


def masked_pairwise_sq_dist(x, y, x_mask=None, y_mask=None, fill: float = _INF) -> torch.Tensor:
    """pairwise_sq_dist with invalid rows/cols pushed to `fill`."""
    d2 = pairwise_sq_dist(x, y)
    fill_t = torch.tensor(fill, dtype=d2.dtype, device=d2.device)
    if y_mask is not None:
        d2 = torch.where(y_mask[..., None, :], d2, fill_t)
    if x_mask is not None:
        d2 = torch.where(x_mask[..., :, None], d2, fill_t)
    return d2


def _angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle between 3-vectors along the last axis, in [0, pi]."""
    y = torch.sum(a * b, dim=-1)
    x = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1), dim=-1)
    return torch.atan2(x, y)


def calc_ppf(points, point_normals, group_points, group_normals) -> torch.Tensor:
    """Point-pair features of each point against its neighborhood.

    points/point_normals (N, 3), group_points/group_normals (N, K, 3) ->
    (N, K, 4) = [||d||, angle(n1, d)/pi, angle(n2, d)/pi, angle(n1, n2)/pi]
    (reference lib/utils.py:358-389).
    """
    c = points[..., :, None, :]
    nc = point_normals[..., :, None, :]
    vec_d = group_points - c
    d = torch.linalg.norm(vec_d, dim=-1, keepdim=True)
    a1 = _angle(nc.expand_as(vec_d), vec_d)[..., None] / math.pi
    a2 = _angle(group_normals, vec_d)[..., None] / math.pi
    a3 = _angle(nc.expand_as(group_normals), group_normals)[..., None] / math.pi
    return torch.cat([d, a1, a2, a3], dim=-1)


def apply_transform(points: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """points (..., 3) x rot (3, 3) + trans (3,) or (3, 1) -> (..., 3)."""
    return points @ rot.t() + trans.reshape(3)
