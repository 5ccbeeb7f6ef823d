"""Log-domain Sinkhorn iterations and their reverse mode (csrc/sinkhorn.cu).

Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py: `_sinkhorn_kernel` via
`_pallas_forward` (a fixed `num_iter` of u = mu - lse_n(s + v),
v = nu - lse_m(s + u) from u = v = 0, returning s + u + v; the caller
subtracts the normaliser) and `_sinkhorn_bwd_kernel` via `_pallas_backward`
(recompute of the u/v trajectory, then the reverse loop). `sinkhorn` is the
differentiable entry: its forward is one kernel launch on the card, its
backward another.
"""

from __future__ import annotations

import ctypes

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr

# shared memory a block of the H100 can take (227 KB), which the C entry
# points ask for with cudaFuncSetAttribute and are refused above
_SMEM_BYTES = 232448


def supported_shape(m1: int, n1: int) -> bool:
    """Whether the forward kernel takes an (m1, n1) patch: its scores and
    both potentials fit a block's shared memory (mirrors
    csrc/sinkhorn.cu:267, `roitr_sinkhorn`)."""
    return 4 * (m1 * n1 + 2 * m1 + 2 * n1) <= _SMEM_BYTES


def supported_shape_bwd(m1: int, n1: int, num_iter: int) -> bool:
    """Whether the backward kernel takes an (m1, n1) patch at num_iter
    steps: scores, their cotangent, the u/v trajectory and five vectors fit
    a block's shared memory (mirrors csrc/sinkhorn.cu:250-252,
    `roitr_sinkhorn_bwd`)."""
    return num_iter >= 1 and 4 * (2 * m1 * n1 + num_iter * (m1 + n1)
                                  + 3 * (m1 + n1)) <= _SMEM_BYTES


def _trajectory(padded, log_mu, log_nu, num_iter: int):
    """[(u_1, v_1), ..., (u_T, v_T)] of the loop (roitr_tpu/ops/sinkhorn.py:125-134)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    out = []
    for _ in range(num_iter):
        u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
        out.append((u, v))
    return out


def sinkhorn_plain(padded, log_mu, log_nu, num_iter: int):
    """padded (P, M1, N1), log_mu (P, M1), log_nu (P, N1) -> s + u + v."""
    u, v = _trajectory(padded, log_mu, log_nu, num_iter)[-1]
    return padded + u[:, :, None] + v[:, None, :]


def sinkhorn_bwd_plain(padded, log_mu, log_nu, g, num_iter: int):
    """Cotangent g of s + u + v -> (ds, dmu, dnu): the reverse loop of
    roitr_tpu `_sinkhorn_bwd_kernel`, with a_t / b_t the row / column
    softmaxes of step t."""
    traj = _trajectory(padded, log_mu, log_nu, num_iter)
    ds = g.clone()
    du = g.sum(dim=2)
    dv = g.sum(dim=1)
    dmu = torch.zeros_like(log_mu)
    dnu = torch.zeros_like(log_nu)
    for t in range(num_iter - 1, -1, -1):
        u_t, v_t = traj[t]
        v_prev = traj[t - 1][1] if t > 0 else torch.zeros_like(log_nu)
        b_t = torch.exp(padded + u_t[:, :, None] - log_nu[:, None, :] + v_t[:, None, :])
        dnu = dnu + dv
        dvb = dv[:, None, :] * b_t
        ds = ds - dvb
        du = du - dvb.sum(dim=2)
        a_t = torch.exp(padded + v_prev[:, None, :] - log_mu[:, :, None] + u_t[:, :, None])
        dmu = dmu + du
        dua = du[:, :, None] * a_t
        ds = ds - dua
        dv = -dua.sum(dim=1)
        du = torch.zeros_like(du)
    return ds, dmu, dnu


def _check(padded, log_mu, log_nu):
    dev = padded.device
    p, m1, n1 = padded.shape
    check_cuda(padded, "scores", torch.float32, (p, m1, n1), dev)
    check_cuda(log_mu, "log_mu", torch.float32, (p, m1), dev)
    check_cuda(log_nu, "log_nu", torch.float32, (p, n1), dev)
    return dev, p, m1, n1


def sinkhorn_iterate(padded, log_mu, log_nu, num_iter: int):
    """Same function and arguments as sinkhorn_plain; one kernel launch on
    the card."""
    if route(padded) == "plain":
        return sinkhorn_plain(padded, log_mu, log_nu, num_iter)
    from roitr_torch.kernels.build import function

    dev, p, m1, n1 = _check(padded, log_mu, log_nu)
    out = torch.empty_like(padded)
    fn = function("sinkhorn", "roitr_sinkhorn",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(padded), ptr(log_mu), ptr(log_nu), ptr(out), p, m1, n1, num_iter,
             stream_ptr(dev))
    check_launch(err, "sinkhorn")
    launch_counts["sinkhorn"] += 1
    return out


def sinkhorn_bwd(padded, log_mu, log_nu, g, num_iter: int):
    """Same function and arguments as sinkhorn_bwd_plain; one kernel launch
    on the card."""
    if route(padded) == "plain":
        return sinkhorn_bwd_plain(padded, log_mu, log_nu, g, num_iter)
    from roitr_torch.kernels.build import function

    dev, p, m1, n1 = _check(padded, log_mu, log_nu)
    check_cuda(g, "g", torch.float32, (p, m1, n1), dev)
    ds = torch.empty_like(padded)
    dmu = torch.empty_like(log_mu)
    dnu = torch.empty_like(log_nu)
    fn = function("sinkhorn", "roitr_sinkhorn_bwd",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(padded), ptr(log_mu), ptr(log_nu), ptr(g), ptr(ds), ptr(dmu), ptr(dnu), p, m1,
             n1, num_iter, stream_ptr(dev))
    check_launch(err, "sinkhorn_bwd")
    launch_counts["sinkhorn_bwd"] += 1
    return ds, dmu, dnu


class _Sinkhorn(torch.autograd.Function):
    """Forward: sinkhorn_iterate, or with kernel=False sinkhorn_plain; saves
    its inputs (roitr_tpu `_vjp_fwd`). Backward: sinkhorn_bwd, or
    sinkhorn_bwd_plain, which recomputes the trajectory as the kernel does
    (the JAX package's checkpointed scan) instead of keeping every step."""

    @staticmethod
    def forward(ctx, padded, log_mu, log_nu, num_iter, kernel):
        ctx.num_iter = num_iter
        ctx.kernel = kernel
        ctx.save_for_backward(padded, log_mu, log_nu)
        return (sinkhorn_iterate if kernel else sinkhorn_plain)(padded, log_mu, log_nu, num_iter)

    @staticmethod
    def backward(ctx, g):
        padded, log_mu, log_nu = ctx.saved_tensors
        bwd = sinkhorn_bwd if ctx.kernel else sinkhorn_bwd_plain
        ds, dmu, dnu = bwd(padded, log_mu, log_nu, g.contiguous(), ctx.num_iter)
        return ds, dmu, dnu, None, None


def sinkhorn(padded, log_mu, log_nu, num_iter: int, kernel: bool = True):
    """Differentiable sinkhorn_iterate; kernel=False takes the plain loop
    forward and backward, on whatever device the tensors are."""
    return _Sinkhorn.apply(padded, log_mu, log_nu, num_iter, kernel)
