"""Seeded synthetic point-cloud pairs: the benchmark's traffic data.

A frozen copy of the program's generators (surface pairs with a random
ground-truth motion, and non-rigid pairs under a smooth sine flow), so that
a later change to the program's data code cannot change what the
benchmark sends. Numbers are drawn with numpy from a RandomState.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """A RandomState for one purpose (`stream`) of a run seeded `seed`; any
    non-negative seed, also past 32 bits."""
    words = np.random.SeedSequence([int(seed), int(stream)]).generate_state(1)
    return np.random.RandomState(int(words[0]))


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def surface_cloud(rng: np.random.RandomState, n: int, scale: float = 3.0) -> np.ndarray:
    """Points near a smooth random height field: locally planar, as indoor
    scans are, so that PCA normals are defined."""
    xy = rng.rand(n, 2).astype(np.float32) * scale
    freqs = rng.randn(4, 2).astype(np.float32)
    phases = rng.rand(4).astype(np.float32) * 2 * np.pi
    amps = (rng.rand(4).astype(np.float32) * 0.3 + 0.1) / np.arange(1, 5)
    z = sum(a * np.sin(xy @ f + p) for a, f, p in zip(amps, freqs, phases))
    pts = np.stack([xy[:, 0], xy[:, 1], z], axis=1)
    pts += rng.randn(n, 3).astype(np.float32) * 0.005
    return pts.astype(np.float32)


def surface_pair(rng: np.random.RandomState, n_src: int, n_tgt: int, overlap: float = 0.7):
    """(src (n_src, 3), tgt (n_tgt, 3), rot (3, 3), trans (3, 1)): two views
    of one surface, src @ rot.T + trans.T ~ tgt on the overlap."""
    total = n_src + int(n_tgt * (1 - overlap)) + 8
    scene = surface_cloud(rng, total)
    rot = random_rotation(rng)
    trans = (rng.randn(3, 1) * 0.5).astype(np.float32)
    start = max(int((1 - overlap) * n_src), 0)
    tgt = scene[start: start + n_tgt]
    if tgt.shape[0] < n_tgt:
        reps = int(np.ceil(n_tgt / max(tgt.shape[0], 1)))
        tgt = np.tile(tgt, (reps, 1))[:n_tgt]
    src = (scene[:n_src] - trans.T) @ rot
    return src.astype(np.float32), np.ascontiguousarray(tgt), rot, trans


def flow_pair(rng: np.random.RandomState, n_src: int, n_tgt: int, overlap: float = 0.7,
              flow_scale: float = 0.08):
    """A non-rigid pair: surface_pair's source is the deformed source; the
    raw source is it bent back by a smooth sine flow. Returns (raw src,
    deformed src, tgt, rot, trans)."""
    deformed, tgt, rot, trans = surface_pair(rng, n_src, n_tgt, overlap)
    freqs = rng.randn(3, 3).astype(np.float32) * 1.5
    phases = rng.rand(3).astype(np.float32) * 2 * np.pi
    flow = flow_scale * np.stack([np.sin(deformed @ freqs[i] + phases[i]) for i in range(3)],
                                 axis=1).astype(np.float32)
    return (deformed - flow).astype(np.float32), deformed, tgt, rot, trans


def count_pairs(lo: int, hi: int, n: int):
    """n (src, tgt) point counts: sources evenly spaced over [lo, hi] and
    targets the same counts in reverse, so every seed sends the same sizes."""
    counts = np.linspace(lo, hi, n).round().astype(int)
    return list(zip(counts.tolist(), counts[::-1].tolist()))
