"""Farthest point sampling over prefix-packed padded clouds.

Counterpart of roitr_tpu/ops/fps.py. The clouds of a batch (on the main
path, the two clouds of a pair) are sampled together: one kernel launch on
the card (kernels/fps_kernel.py), the plain loop on the CPU. Seed index 0;
padded points are never picked; surplus slots repeat the seed and are
masked by the caller through `num_valid_samples`.
"""

from __future__ import annotations

import torch

from roitr_torch.kernels.fps_kernel import fps_pairs
from roitr_torch.utils.profiling import span


def furthest_point_sampling(points: torch.Tensor, counts: torch.Tensor,
                            num_samples: int) -> torch.Tensor:
    """points (B, N, 3) with `counts` (B,) valid prefix rows ->
    idx (B, num_samples) int64."""
    with span("fps", points.device):
        return fps_pairs(points.contiguous(), counts, num_samples).long()


def num_valid_samples(count, stride: int):
    """Number of valid FPS samples: max(n // stride, 1) (reference
    model.py:59-63)."""
    return torch.clamp(count // stride, min=1)
