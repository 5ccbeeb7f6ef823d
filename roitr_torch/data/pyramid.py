"""Host-side precomputation of the backbone's geometric pyramid.

Counterpart of roitr_tpu/data/pyramid.py. Per level: the FPS indices into
the parent level, the cross kNN (each sampled point's nsample nearest
parent points, itself excluded), the self kNN within the level, and the
decoder's 3-NN upsampling indices and inverse-distance weights. With a
pyramid attached to a pair, the backbone (models/backbone.py) runs neither
FPS nor kNN itself.

Index semantics are the device path's (models/backbone.py): level l > 1
points are FPS samples of level l-1 seeded at index 0 (reference
sampling_cuda_kernel.cu:39), count_l = max(count_{l-1} // 4, 1); kNN lists
exclude the point itself (reference functions/pointops.py:88-89); a level
with fewer than nsample + 1 valid points pads its lists with index 0, the
reference kernel's segment-start padding, and those phantom neighbours
take part in attention. Pad rows of every field are zero.

The searches run in the port's native library (roitr_torch/native, g++ at
first use); `backend="scipy"` takes cKDTree and a numpy FPS loop instead.
The JAX package falls back to that path silently when its library is
missing; the port does so only when asked.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CloudPyramid(NamedTuple):
    fps_idx2: np.ndarray  # (B/4,) int32 into level 1
    fps_idx3: np.ndarray  # (B/16,) into level 2
    fps_idx4: np.ndarray  # (B/64,) into level 3
    cross_idx1: np.ndarray  # (B, k1) level-1 self-set (stride 1)
    cross_idx2: np.ndarray  # (B/4, k2) level-2 queries among level-1 keys
    cross_idx3: np.ndarray
    cross_idx4: np.ndarray
    self_idx1: np.ndarray  # (B, k1)
    self_idx2: np.ndarray  # (B/4, k2)
    self_idx3: np.ndarray
    self_idx4: np.ndarray
    # decoder 3-NN upsampling (queries = level l-1, keys = level l):
    # idx (M_{l-1}, 3) + inverse-distance weights (M_{l-1}, 3)
    up_idx2: np.ndarray  # level 2 -> level 1
    up_w2: np.ndarray
    up_idx3: np.ndarray  # level 3 -> level 2
    up_w3: np.ndarray
    up_idx4: np.ndarray  # level 4 -> level 3
    up_w4: np.ndarray


# the level whose rows each index field points into: fps_idx{l} and
# cross_idx{l} index level l-1 (level 1 for l = 1), self_idx{l} and
# up_idx{l} level l; a packed batch offsets pair b's indices by b times
# that level's capacity (data/packing.py, ops/pyramid.py)
KEY_LEVEL = {
    "fps_idx2": 1, "fps_idx3": 2, "fps_idx4": 3,
    "cross_idx1": 1, "cross_idx2": 1, "cross_idx3": 2, "cross_idx4": 3,
    "self_idx1": 1, "self_idx2": 2, "self_idx3": 3, "self_idx4": 4,
    "up_idx2": 2, "up_idx3": 3, "up_idx4": 4,
}

_BACKENDS = ("native", "scipy")


def _nearest(keys: np.ndarray, queries: np.ndarray, kk: int, backend: str):
    """(idx (Q, kk) int, dist (Q, kk)) of the kk nearest keys, ascending."""
    if backend == "native":
        from roitr_torch import native

        idx, dist = native.knn(keys, queries, kk)
        return np.where(idx < 0, 0, idx), dist
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(keys).query(queries, k=kk)
    if kk == 1:
        dist, idx = dist[:, None], idx[:, None]
    return idx, dist


def _knn_host(keys: np.ndarray, queries: np.ndarray, k: int, backend: str = "native"
              ) -> np.ndarray:
    """Self-excluded kNN with the device path's semantics (ops/neighbors.py
    masked_knn): always k columns; when fewer than k + 1 keys exist, the
    trailing slots are key index 0, the reference kernel's short-segment
    padding (knnquery_cuda_kernel.cu:65-108)."""
    kk = min(k + 1, keys.shape[0])
    idx, _ = _nearest(keys, queries, kk, backend)
    idx = idx[:, 1:] if kk > 1 else idx[:, :0]
    missing = k - idx.shape[1]
    if missing > 0:
        idx = np.concatenate([idx, np.zeros((idx.shape[0], missing), np.int64)], axis=1)
    return idx.astype(np.int32)


def _fps_host(points: np.ndarray, m: int, backend: str = "native") -> np.ndarray:
    """(m,) int32 exact FPS picks, seed index 0."""
    if backend == "native":
        from roitr_torch import native

        return native.fps(points, m)
    dist = np.full(points.shape[0], np.inf, np.float64)
    out = np.zeros(m, np.int32)
    last = 0
    for s in range(1, m):
        d = ((points - points[last]) ** 2).sum(-1)
        np.minimum(dist, d, out=dist)
        last = int(np.argmax(dist))
        out[s] = last
    return out


def build_cloud_pyramid(points: np.ndarray, count: int, strides=(1, 4, 4, 4),
                        nsample=(8, 16, 16, 16), backend: str = "native") -> CloudPyramid:
    """points: (bucket, 3) prefix-packed with `count` valid rows."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    bucket = points.shape[0]
    count = int(count)
    cur = np.ascontiguousarray(points[:count], np.float32)
    cur_bucket = bucket

    fps_list, cross_list, self_list, up_list = [], [], [], []
    for stride, k in zip(strides, nsample):
        new_bucket = cur_bucket // stride
        if stride != 1:
            m = max(len(cur) // stride, 1)
            idx_valid = _fps_host(cur, m, backend)
            new = cur[idx_valid]
            fps_idx = np.zeros(new_bucket, np.int32)
            fps_idx[:m] = idx_valid
            fps_list.append(fps_idx)

            # decoder 3-NN interpolation: queries = this level's parents
            # (cur), keys = the sampled set (new), as three_nn_interpolate
            kk = min(3, len(new))
            up_i, up_d = _nearest(new, cur, kk, backend)
            if kk < 3:
                up_i = np.pad(up_i, ((0, 0), (0, 3 - kk)), mode="edge")
                up_d = np.pad(up_d, ((0, 0), (0, 3 - kk)), constant_values=1e10)
            recip = 1.0 / np.clip(up_d, 1e-8, None)
            w = (recip / recip.sum(-1, keepdims=True)).astype(np.float32)
            up_idx = np.zeros((cur_bucket, 3), np.int32)
            up_w = np.zeros((cur_bucket, 3), np.float32)
            up_idx[: len(cur)] = up_i
            up_w[: len(cur)] = w
            up_list.append((up_idx, up_w))
        else:
            new = cur

        cross_valid = _knn_host(cur, new, k, backend)
        cross = np.zeros((new_bucket, cross_valid.shape[1]), np.int32)
        cross[: len(new)] = cross_valid
        cross_list.append(cross)

        self_valid = _knn_host(new, new, k, backend)
        self_idx = np.zeros((new_bucket, self_valid.shape[1]), np.int32)
        self_idx[: len(new)] = self_valid
        self_list.append(self_idx)

        cur = new
        cur_bucket = new_bucket

    return CloudPyramid(
        fps_idx2=fps_list[0], fps_idx3=fps_list[1], fps_idx4=fps_list[2],
        cross_idx1=cross_list[0], cross_idx2=cross_list[1], cross_idx3=cross_list[2],
        cross_idx4=cross_list[3],
        self_idx1=self_list[0], self_idx2=self_list[1], self_idx3=self_list[2],
        self_idx4=self_list[3],
        up_idx2=up_list[0][0], up_w2=up_list[0][1], up_idx3=up_list[1][0],
        up_w3=up_list[1][1], up_idx4=up_list[2][0], up_w4=up_list[2][1],
    )


def pyramid_to_torch(pyr: CloudPyramid, device="cpu") -> CloudPyramid:
    """A host pyramid as tensors on `device`: indices int64, weights fp32
    (a pyramid of tensors passes through unchanged in value)."""
    import torch

    def conv(name, a):
        dtype = torch.float32 if name.startswith("up_w") else torch.int64
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return CloudPyramid(*(conv(name, a) for name, a in zip(CloudPyramid._fields, pyr)))
