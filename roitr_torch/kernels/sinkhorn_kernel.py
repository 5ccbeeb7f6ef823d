"""Log-domain Sinkhorn iterations (csrc/sinkhorn.cu).

Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py `_sinkhorn_kernel` via
`_pallas_forward` / `sinkhorn_iterate_pallas`: a fixed `num_iter` of
u = mu - lse_n(s + v), v = nu - lse_m(s + u) from u = v = 0, returning
s + u + v (the caller subtracts the normaliser).
"""

from __future__ import annotations

import ctypes

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def sinkhorn_plain(padded, log_mu, log_nu, num_iter: int):
    """padded (P, M1, N1), log_mu (P, M1), log_nu (P, N1) -> s + u + v
    (the loop of roitr_tpu/ops/sinkhorn.py:125-134)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iter):
        u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
    return padded + u[:, :, None] + v[:, None, :]


def sinkhorn_iterate(padded, log_mu, log_nu, num_iter: int):
    """Same function and arguments as sinkhorn_plain; one kernel launch on
    the card."""
    if route(padded) == "plain":
        return sinkhorn_plain(padded, log_mu, log_nu, num_iter)
    from roitr_torch.kernels.build import function

    dev = padded.device
    p, m1, n1 = padded.shape
    check_cuda(padded, "scores", torch.float32, (p, m1, n1), dev)
    check_cuda(log_mu, "log_mu", torch.float32, (p, m1), dev)
    check_cuda(log_nu, "log_nu", torch.float32, (p, n1), dev)
    out = torch.empty_like(padded)
    fn = function("sinkhorn", "roitr_sinkhorn",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(padded), ptr(log_mu), ptr(log_nu), ptr(out), p, m1, n1, num_iter,
             stream_ptr(dev))
    check_launch(err, "sinkhorn")
    launch_counts["sinkhorn"] += 1
    return out
