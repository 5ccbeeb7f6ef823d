"""Synthetic partially-overlapping pairs (host-side numpy).

Counterpart of roitr_tpu/data/synthetic.py: surface-like local structure
(so PCA normals are meaningful), a random SO(3) ground-truth transform,
prefix-packed padding to a bucket, and non-rigid pairs under a smooth
flow. `SyntheticPairs` serves rigid pairs as a dataset of preprocessed
items, normals included.
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


def make_flow_pair_arrays(rng: np.random.RandomState, bucket: int, n_valid: int, m_valid: int,
                          overlap: float = 0.7, flow_scale: float = 0.08):
    """A non-rigid (4DMatch-style) pair: make_pair_arrays' source, which
    the GT transform carries onto the target, is the deformed source; the
    raw source is it bent back by a smooth sine flow, so raw + flow ==
    deformed (reference dataset/fdmatch.py:31-98: s_pc + s2t_flow is the
    matching geometry, s_pc carries the normals and the backbone). Returns
    make_pair_arrays' dict, src_raw_points the raw source, plus 'flow'
    (bucket, 3), zero past the source's count."""
    arr = make_pair_arrays(rng, bucket, n_valid, m_valid, overlap)
    deformed = arr["src_points"]
    freqs = rng.randn(3, 3).astype(np.float32) * 1.5
    phases = rng.rand(3).astype(np.float32) * 2 * np.pi
    flow = flow_scale * np.stack(
        [np.sin(deformed @ freqs[i] + phases[i]) for i in range(3)], axis=1).astype(np.float32)
    flow[arr["src_count"]:] = 0.0
    arr["src_raw_points"] = (deformed - flow).astype(np.float32)
    arr["flow"] = flow
    return arr


class SyntheticPairs:
    """A dataset of `n` seeded synthetic pairs in one bucket, each item the
    preprocessed dict a training dataset yields: points, normals (kNN PCA,
    redirected to the origin as data/preprocess.py does), ones as features,
    counts and the GT transform. Item i draws its point counts uniformly
    from `counts` with RandomState(seed + i)."""

    def __init__(self, n: int, bucket: int, counts=None, seed: int = 0, normal_knn: int = 33):
        self.n, self.bucket, self.seed, self.normal_knn = n, bucket, seed, normal_knn
        self.counts = counts or (bucket - bucket // 8, bucket)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np

        if not 0 <= i < self.n:
            raise IndexError(i)
        rng = np.random.RandomState(self.seed + i)
        lo, hi = self.counts
        n_valid, m_valid = (int(c) for c in rng.randint(lo, hi + 1, size=2))
        arr = make_pair_arrays(rng, self.bucket, n_valid, m_valid)
        for side, c in (("src", n_valid), ("tgt", m_valid)):
            pts = arr[f"{side}_points"]
            nrm = np.zeros_like(pts)
            nrm[:c] = normal_redirect_np(pts[:c], estimate_normals_np(pts[:c], self.normal_knn),
                                         np.zeros(3, np.float32))
            arr[f"{side}_normals"] = nrm
            arr[f"{side}_feats"] = np.ones((self.bucket, 1), np.float32)
        return arr
