"""Masked log-domain Sinkhorn optimal transport with a learnable dustbin.

Counterpart of roitr_tpu/ops/sinkhorn.py (reference model/modules.py:10-72).
Under backend "pallas" (the default) the fixed iteration count runs as one
kernel launch on the card (kernels/sinkhorn_kernel.py) and as the plain
loop on the CPU, and so does their reverse mode. As in the JAX package, a
patch the kernels do not take (their shape gates) runs the plain loop on
the card too, and backend "xla" takes the plain loop everywhere. Wherever
the kernel does not run, `tol` > 0 stops the loop early
(`sinkhorn_early_exit`, JAX's `while_loop`). Everything is fp32.
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


def sinkhorn_early_exit(padded: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                        num_iter: int, tol: float):
    """The plain loop with JAX's convergence exit (roitr_tpu/ops/sinkhorn.py:
    97-118): it stops after the first iteration whose largest row-potential
    update over the whole batch, finite rows only, is <= tol, and after
    num_iter at most. Returns (s + u + v, the iterations run). Each
    iteration reads the update on the host."""
    finite_u = log_mu > -_INF / 2
    tol = torch.tensor(tol, dtype=torch.float32).item()  # JAX compares in fp32
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    it = 0
    delta = float("inf")
    while it < num_iter and delta > tol:
        u_new = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u_new[:, :, None], dim=1)
        delta = float(torch.where(finite_u, (u_new - u).abs(), 0.0).max())
        u = u_new
        it += 1
    return padded + u[:, :, None] + v[:, None, :], it


SINKHORN_BACKENDS = ("pallas", "xla")


def log_sinkhorn_ot(scores: torch.Tensor, row_masks: torch.Tensor, col_masks: torch.Tensor,
                    alpha: torch.Tensor, num_iter: int = 100, tol: float = 0.0,
                    differentiable: bool = False, backend: str = "pallas") -> torch.Tensor:
    """scores (B, M, N), row_masks (B, M), col_masks (B, N), alpha (learnable
    dustbin score) -> log assignment matrix (B, M+1, N+1).

    Under backend "pallas" the iterations run as the kernel on the card and
    as the plain loop on the CPU; under "xla" as the plain loop on either.
    Differentiable in scores and alpha (alpha through the padded scores, as
    in JAX). `differentiable` says a backward follows, so the patch must fit
    the backward kernel too (kernel_takes); a patch the kernels do not take
    runs the plain loop, forward and backward, on the card as well. With
    tol > 0 the plain loop exits early (sinkhorn_early_exit); the kernel
    runs the fixed count and warns, as the JAX package's kernel path does.
    """
    if backend not in SINKHORN_BACKENDS:
        raise ValueError(f"sinkhorn backend must be one of {SINKHORN_BACKENDS}, got {backend!r}")
    padded, log_mu, log_nu, norm = sinkhorn_inputs(scores, row_masks, col_masks, alpha)
    _, m1, n1 = padded.shape
    kernel = backend == "pallas" and kernel_takes(m1, n1, num_iter, differentiable)
    if tol > 0.0 and not (kernel and padded.is_cuda):
        out, _ = sinkhorn_early_exit(padded, log_mu, log_nu, num_iter, tol)
        return out - norm[:, None, None]
    if tol > 0.0:
        warnings.warn("sinkhorn_tol > 0 has no effect on the Sinkhorn kernel (it always runs "
                      "the fixed iteration count); use sinkhorn_backend='xla' for the "
                      "convergence early exit", stacklevel=2)
    out = sinkhorn(padded, log_mu, log_nu, num_iter, kernel=kernel)
    return out - norm[:, None, None]
