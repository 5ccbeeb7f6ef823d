"""Utility ops of the reference outside the live pipeline.

Counterpart of roitr_tpu/ops/legacy.py: helpers the reference ships but
its model path no longer calls, kept for the scripts that may use them.

- `sinkhorn`: the slack-variant log-Sinkhorn (reference lib/utils.py:221-279)
  of RPM-style matchers; unlike ops/sinkhorn.py's masked OT, the slack row
  and column are appended as zeros and left out of the normalisation.
- `soft_assignment`: differentiable soft correspondences and confidences
  (reference lib/utils.py:296-320).
- `interpolate`: weighted coordinate blending (reference lib/utils.py:283-293).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from roitr_torch.ops.geometry import pairwise_sq_dist


def sinkhorn(log_alpha: torch.Tensor, n_iters: int = 5, slack: bool = True) -> torch.Tensor:
    """log_alpha (B, J, K) -> log doubly-stochastic matrix (B, J, K)."""
    if not slack:
        p = log_alpha
        for _ in range(n_iters):
            p = p - torch.logsumexp(p, dim=2, keepdim=True)
            p = p - torch.logsumexp(p, dim=1, keepdim=True)
        return p
    p = F.pad(log_alpha, (0, 1, 0, 1))
    for _ in range(n_iters):
        # every row but the slack row, then every column but the slack column
        p = torch.cat([p[:, :-1, :] - torch.logsumexp(p[:, :-1, :], dim=2, keepdim=True),
                       p[:, -1:, :]], dim=1)
        p = torch.cat([p[:, :, :-1] - torch.logsumexp(p[:, :, :-1], dim=1, keepdim=True),
                       p[:, :, -1:]], dim=2)
    return p[:, :-1, :-1]


def interpolate(weights: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """weights (b, n, m), points (b, m, 3) -> blended coordinates (b, n, 3)."""
    return torch.einsum("bnm,bmc->bnc", weights, points)


def soft_assignment(src_xyz: torch.Tensor, src_feats: torch.Tensor, tgt_xyz: torch.Tensor,
                    tgt_feats: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable correspondences by inverse feature distance.

    Returns (src2tgt confidence (b, n), src2tgt xyz (b, n, 3),
             tgt2src confidence (b, m), tgt2src xyz (b, m, 3)).
    """
    sim = 1.0 / (1e-8 + torch.sqrt(pairwise_sq_dist(src_feats, tgt_feats)))  # (b, n, m)

    s2t_w = sim / torch.sum(sim, dim=-1, keepdim=True)
    s2t_max = torch.amax(sim, dim=-1)
    s2t_conf = s2t_max / torch.sum(s2t_max, dim=-1, keepdim=True)
    s2t_xyz = interpolate(s2t_w, tgt_xyz)

    t2s_w = sim / torch.sum(sim, dim=1, keepdim=True)
    t2s_max = torch.amax(sim, dim=1)
    t2s_conf = t2s_max / torch.sum(t2s_max, dim=-1, keepdim=True)
    t2s_xyz = interpolate(t2s_w.transpose(1, 2), src_xyz)
    return s2t_conf, s2t_xyz, t2s_conf, t2s_xyz
