"""Masked log-domain Sinkhorn optimal transport with a learnable dustbin.

Counterpart of roitr_tpu/ops/sinkhorn.py (reference model/modules.py:10-72)
with a fixed iteration count: the iterations run as one kernel launch on
the card (kernels/sinkhorn_kernel.py), the plain loop on the CPU, and so
does their reverse mode. As in the JAX package, a patch the kernels do
not take (their shape gates) runs the plain loop on the card too.
Everything is fp32.
"""

from __future__ import annotations

import warnings

import torch

from roitr_torch.kernels.sinkhorn_kernel import sinkhorn, supported_shape, supported_shape_bwd

_INF = 1e6


def sinkhorn_inputs(scores: torch.Tensor, row_masks: torch.Tensor, col_masks: torch.Tensor,
                    alpha: torch.Tensor):
    """scores (B, M, N) + masks + dustbin score -> (padded (B, M+1, N+1),
    log_mu (B, M+1), log_nu (B, N+1), norm (B,)), the iteration's inputs.

    Invalid rows/cols hold -1e6; the dustbin marginals absorb the other
    side (log_mu[-1] = log(num_valid_col) + norm, ...), as in reference
    model/modules.py:28-68.
    """
    scores = scores.to(torch.float32)
    b, m, n = scores.shape
    dev = scores.device
    zeros = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    row_invalid = torch.cat([~row_masks, zeros], dim=1)  # (B, M+1)
    col_invalid = torch.cat([~col_masks, zeros], dim=1)  # (B, N+1)

    alpha = alpha.to(torch.float32)
    padded = torch.cat([torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
                        alpha.expand(b, 1, n + 1)], dim=1)
    neg = torch.tensor(-_INF, dtype=torch.float32, device=dev)
    padded = torch.where(row_invalid[:, :, None] | col_invalid[:, None, :], neg, padded)

    # clamp to >= 1 so fully-masked patch slots stay finite
    nrow = torch.clamp(row_masks.sum(dim=1).to(torch.float32), min=1.0)
    ncol = torch.clamp(col_masks.sum(dim=1).to(torch.float32), min=1.0)
    norm = -torch.log(nrow + ncol)  # (B,)
    log_mu = torch.cat([norm[:, None].expand(b, m), (torch.log(ncol) + norm)[:, None]], dim=1)
    log_mu = torch.where(row_invalid, neg, log_mu)
    log_nu = torch.cat([norm[:, None].expand(b, n), (torch.log(nrow) + norm)[:, None]], dim=1)
    log_nu = torch.where(col_invalid, neg, log_nu)
    return padded.contiguous(), log_mu.contiguous(), log_nu.contiguous(), norm


def kernel_takes(m1: int, n1: int, num_iter: int, differentiable: bool) -> bool:
    """Whether log_sinkhorn_ot runs the kernels on an (m1, n1) padded
    patch: a differentiable call needs the backward's shape, any other the
    forward's (roitr_tpu/ops/sinkhorn.py:80-93)."""
    return supported_shape_bwd(m1, n1, num_iter) if differentiable else supported_shape(m1, n1)


def log_sinkhorn_ot(scores: torch.Tensor, row_masks: torch.Tensor, col_masks: torch.Tensor,
                    alpha: torch.Tensor, num_iter: int = 100, tol: float = 0.0,
                    differentiable: bool = False) -> torch.Tensor:
    """scores (B, M, N), row_masks (B, M), col_masks (B, N), alpha (learnable
    dustbin score) -> log assignment matrix (B, M+1, N+1).

    The iterations run as the kernel on the card and as the plain loop on
    the CPU; differentiable in scores and alpha (alpha through the padded
    scores, as in JAX). The iteration count is fixed: tol > 0 is ignored
    with a warning, as on the JAX package's kernel path. `differentiable`
    says a backward follows, so the patch must fit the backward kernel too
    (kernel_takes); a patch the kernels do not take runs the plain loop,
    forward and backward, on the card as well.
    """
    if tol > 0.0:
        warnings.warn("sinkhorn_tol > 0 has no effect: the port always runs the fixed "
                      "iteration count", stacklevel=2)
    padded, log_mu, log_nu, norm = sinkhorn_inputs(scores, row_masks, col_masks, alpha)
    _, m1, n1 = padded.shape
    out = sinkhorn(padded, log_mu, log_nu, num_iter,
                   kernel=kernel_takes(m1, n1, num_iter, differentiable))
    return out - norm[:, None, None]
