"""Offline patch-construction helpers (numpy).

The port's copy of roitr_tpu/data/patches.py, counterparts of the
reference's CPU preprocessing utilities (dataset/common.py:194-552:
ball-query patches, CPU PPF, point2node sampling, crops). The live
pipeline uses the padded-bucket path in preprocess.py/pyramid.py; these
helpers serve offline dataset preparation and analysis tooling.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def ball_query_patches(
    points: np.ndarray,
    nodes: np.ndarray,
    radius: float,
    max_points: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each node, up to `max_points` points within `radius`.

    Returns (idx (M, K) int32, mask (M, K) bool); short patches are padded
    with the node's nearest point index (masked False). Matches the
    reference's collect_local_neighbors semantics (common.py:220-265) with
    random subsampling when a patch overflows.
    """
    from scipy.spatial import cKDTree

    rng = rng or np.random.RandomState(0)
    tree = cKDTree(points)
    m = nodes.shape[0]
    idx = np.zeros((m, max_points), np.int32)
    mask = np.zeros((m, max_points), bool)
    _, nearest = tree.query(nodes, k=1)
    for i in range(m):
        neigh = tree.query_ball_point(nodes[i], radius)
        if len(neigh) > max_points:
            neigh = rng.choice(neigh, max_points, replace=False)
        k = len(neigh)
        idx[i, :k] = neigh
        mask[i, :k] = True
        idx[i, k:] = nearest[i]
    return idx, mask


def calc_ppf_np(
    points: np.ndarray,
    point_normals: np.ndarray,
    group_points: np.ndarray,
    group_normals: np.ndarray,
) -> np.ndarray:
    """CPU PPF with the exact device formula (ops/geometry.py `calc_ppf`,
    reference dataset/common.py:352-383): [||d||, 3 angles / pi]."""

    def angle(a, b):
        cross = np.linalg.norm(np.cross(a, b), axis=-1)
        dot = np.sum(a * b, axis=-1)
        return np.arctan2(cross, dot)

    c = points[:, None, :]
    nc = np.broadcast_to(point_normals[:, None, :], group_points.shape)
    d = group_points - c
    dist = np.linalg.norm(d, axis=-1, keepdims=True)
    a1 = angle(nc, d)[..., None] / np.pi
    a2 = angle(group_normals, d)[..., None] / np.pi
    a3 = angle(nc, group_normals)[..., None] / np.pi
    return np.concatenate([dist, a1, a2, a3], axis=-1).astype(np.float32)


def point2node_sampling(
    points: np.ndarray, nodes: np.ndarray, max_points: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Assign points to their nearest node; cap each node's member list at
    `max_points` (random subset). Returns (idx (M, K), mask (M, K)).
    Reference common.py:268-309."""
    from scipy.spatial import cKDTree

    rng = rng or np.random.RandomState(0)
    _, owner = cKDTree(nodes).query(points, k=1)
    m = nodes.shape[0]
    idx = np.zeros((m, max_points), np.int32)
    mask = np.zeros((m, max_points), bool)
    for i in range(m):
        members = np.nonzero(owner == i)[0]
        if len(members) > max_points:
            members = rng.choice(members, max_points, replace=False)
        k = len(members)
        idx[i, :k] = members
        mask[i, :k] = True
    return idx, mask


def random_crop(
    points: np.ndarray, keep_ratio: float, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Keep the `keep_ratio` fraction of points on one side of a random
    plane through the centroid (reference common.py:507-529)."""
    rng = rng or np.random.RandomState(0)
    direction = rng.randn(3)
    direction /= np.linalg.norm(direction)
    proj = (points - points.mean(0)) @ direction
    order = np.argsort(proj)
    keep = order[: max(int(len(points) * keep_ratio), 1)]
    return points[np.sort(keep)]


def x_axis_crop(points: np.ndarray, keep_ratio: float) -> np.ndarray:
    """Keep the lower `keep_ratio` fraction along x (reference
    common.py:532-552)."""
    order = np.argsort(points[:, 0])
    keep = order[: max(int(len(points) * keep_ratio), 1)]
    return points[np.sort(keep)]
