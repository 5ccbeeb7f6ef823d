"""Farthest point sampling of a batch of clouds (csrc/fps.cu).

Replaces roitr_tpu/ops/pallas/fps_kernel.py `_kernel` via `fps_pairs`.
Semantics of roitr_tpu/ops/fps.py: the seed is index 0, each pick
maximizes the running min-distance to the picked set with ties to the
first maximum, padded points hold -inf and are never picked, and surplus
slots of a cloud with fewer valid points than samples repeat the seed.
Indices equal the plain version's bit for bit: both round
(x-xs)^2 + (y-ys)^2 + (z-zs)^2 left to right, without FMA.
"""

from __future__ import annotations

import ctypes

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def fps_plain(points: torch.Tensor, counts: torch.Tensor, num_samples: int) -> torch.Tensor:
    """points (B, N, 3) f32, counts (B,) -> idx (B, num_samples) int32."""
    b, n, _ = points.shape
    valid = torch.arange(n, device=points.device)[None, :] < counts.to(points.device)[:, None]
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=points.device)
    dists = torch.where(valid, torch.tensor(1e10, dtype=torch.float32, device=points.device),
                        neg_inf)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = torch.arange(b, device=points.device)
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=points.device)
    last = torch.zeros(b, dtype=torch.int64, device=points.device)
    for i in range(1, num_samples):
        sel = points[rows, last]  # (B, 3)
        dx = x - sel[:, 0:1]
        dy = y - sel[:, 1:2]
        dz = z - sel[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, torch.where(valid, d2, neg_inf))
        last = torch.argmax(dists, dim=1)  # first maximum
        out[:, i] = last.to(torch.int32)
    return out


def fps_pairs(points: torch.Tensor, counts: torch.Tensor, num_samples: int) -> torch.Tensor:
    """points (B, N, 3) f32, counts (B,) int32 -> idx (B, num_samples) int32.

    B is 2 on the main path (the two clouds of a pair, one cluster of 8
    blocks each)."""
    if route(points) == "plain":
        return fps_plain(points, counts, num_samples)
    from roitr_torch.kernels.build import function

    b, n, _ = points.shape
    dev = points.device
    counts = counts.to(device=dev, dtype=torch.int32).contiguous()
    check_cuda(points, "points", torch.float32, (b, n, 3), dev)
    check_cuda(counts, "counts", torch.int32, (b,), dev)
    if not 1 <= num_samples <= n:
        raise ValueError(f"fps: num_samples {num_samples} outside [1, {n}]")
    out = torch.empty((b, num_samples), dtype=torch.int32, device=dev)
    # running distances of clouds too large for shared memory (none for smaller ones)
    scratch_floats = function("fps", "roitr_fps_scratch_floats", [ctypes.c_int])(n)
    scratch = torch.empty((b, scratch_floats), dtype=torch.float32, device=dev)
    fn = function("fps", "roitr_fps", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    err = fn(ptr(points), ptr(counts), ptr(out), ptr(scratch), b, n, num_samples,
             stream_ptr(dev))
    check_launch(err, "fps")
    launch_counts["fps"] += 1
    return out
