"""Synthetic partially-overlapping pairs (host-side numpy).

Counterpart of roitr_tpu/data/synthetic.py: surface-like local structure
(so PCA normals are meaningful), a random SO(3) ground-truth transform, and
prefix-packed padding to a bucket.
"""

from __future__ import annotations

import numpy as np


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def make_surface_cloud(rng: np.random.RandomState, n: int, scale: float = 3.0) -> np.ndarray:
    """Points near a smooth random height-field surface — locally planar, so
    normal estimation behaves as on indoor scans."""
    xy = rng.rand(n, 2).astype(np.float32) * scale
    freqs = rng.randn(4, 2).astype(np.float32)
    phases = rng.rand(4).astype(np.float32) * 2 * np.pi
    amps = (rng.rand(4).astype(np.float32) * 0.3 + 0.1) / np.arange(1, 5)
    z = sum(a * np.sin(xy @ f + p) for a, f, p in zip(amps, freqs, phases))
    pts = np.stack([xy[:, 0], xy[:, 1], z], axis=1)
    pts += rng.randn(n, 3).astype(np.float32) * 0.005
    return pts.astype(np.float32)


def make_pair_arrays(rng: np.random.RandomState, bucket: int, n_valid: int, m_valid: int,
                     overlap: float = 0.7):
    """Dict of numpy arrays for one padded pair with its GT transform
    (src @ rot.T + trans.T ~ tgt on the overlap, reference lib/loss.py:129)."""
    total = n_valid + int(m_valid * (1 - overlap)) + 8
    scene = make_surface_cloud(rng, total)
    rot = random_rotation(rng)
    trans = (rng.randn(3, 1) * 0.5).astype(np.float32)

    src_tgtframe = scene[:n_valid]
    start = max(int((1 - overlap) * n_valid), 0)
    tgt_view = scene[start: start + m_valid]
    if tgt_view.shape[0] < m_valid:  # wrap if the scene ran short
        reps = int(np.ceil(m_valid / max(tgt_view.shape[0], 1)))
        tgt_view = np.tile(tgt_view, (reps, 1))[:m_valid]
    src_view = (src_tgtframe - trans.T) @ rot

    src = np.zeros((bucket, 3), np.float32)
    tgt = np.zeros((bucket, 3), np.float32)
    src[:n_valid] = src_view
    tgt[:m_valid] = tgt_view
    return {
        "src_points": src,
        "src_raw_points": src.copy(),
        "src_count": np.int32(n_valid),
        "tgt_points": tgt,
        "tgt_count": np.int32(m_valid),
        "rot": rot,
        "trans": trans,
    }
