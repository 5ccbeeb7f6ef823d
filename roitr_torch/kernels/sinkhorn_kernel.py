"""Log-domain Sinkhorn iterations and their reverse mode (csrc/sinkhorn.cu).

Replaces roitr_tpu/ops/pallas/sinkhorn_kernel.py: `_sinkhorn_kernel` via
`_pallas_forward` (a fixed `num_iter` of u = mu - lse_n(s + v),
v = nu - lse_m(s + u) from u = v = 0, returning s + u + v; the caller
subtracts the normaliser) and `_sinkhorn_bwd_kernel` via `_pallas_backward`
(the reverse loop over the u/v trajectory). `sinkhorn` is the
differentiable entry: under differentiation its forward is one kernel
launch that also writes the trajectory, and its backward one launch that
reads it; without a gradient the forward writes nothing extra.

Two pairs of kernels take the shapes: the line kernels, for patches whose
rows and columns are at most LINE_KERNEL_LINES long (each line of a patch
reduced at once, in registers, exps in base 2), and the general kernels
for longer lines (the patch in shared memory). The choice is by shape
alone (`line_kernel_takes`, mirroring csrc/sinkhorn.cu `line_shape`); both
admit exactly what `supported_shape` / `supported_shape_bwd` admit.
"""

from __future__ import annotations

import ctypes

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr

# shared memory a block of the H100 can take (227 KB), which the general
# kernels ask for with cudaFuncSetAttribute
_SMEM_BYTES = 232448
# the longest row or column the line kernels take: point_per_patch 64 and
# the dustbin (csrc/sinkhorn.cu kLines)
LINE_KERNEL_LINES = 65
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def supported_shape(m1: int, n1: int) -> bool:
    """Whether the forward kernels take an (m1, n1) patch: its scores and
    both potentials fit a block's shared memory, as the general kernel keeps
    them (mirrors csrc/sinkhorn.cu `roitr_sinkhorn`; every patch of the line
    kernel passes)."""
    return 4 * (m1 * n1 + 2 * m1 + 2 * n1) <= _SMEM_BYTES


def supported_shape_bwd(m1: int, n1: int, num_iter: int) -> bool:
    """Whether the backward kernels take an (m1, n1) patch at num_iter
    steps: scores, their cotangent, the u/v trajectory and five vectors fit
    a block's shared memory, as the general kernel keeps them (mirrors
    csrc/sinkhorn.cu `roitr_sinkhorn_bwd`, which applies the test to the
    line kernel's shapes too, though that kernel reads the trajectory from
    device memory)."""
    return num_iter >= 1 and 4 * (2 * m1 * n1 + num_iter * (m1 + n1)
                                  + 3 * (m1 + n1)) <= _SMEM_BYTES


def line_kernel_takes(m1: int, n1: int) -> bool:
    """Whether an (m1, n1) patch runs the line kernels rather than the
    general ones (mirrors csrc/sinkhorn.cu `line_shape`)."""
    return m1 <= LINE_KERNEL_LINES and n1 <= LINE_KERNEL_LINES


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


def sinkhorn_plain(padded, log_mu, log_nu, num_iter: int, with_traj: bool = False):
    """padded (P, M1, N1), log_mu (P, M1), log_nu (P, N1) -> s + u + v;
    with_traj also returns every step's u (P, T, M1) and v (P, T, N1)."""
    traj = _trajectory(padded, log_mu, log_nu, num_iter)
    u, v = traj[-1]
    out = padded + u[:, :, None] + v[:, None, :]
    if not with_traj:
        return out
    return out, torch.stack([u for u, _ in traj], dim=1), torch.stack([v for _, v in traj], dim=1)


def _lse2_shifted(s2, c, pot, first: bool):
    """One half-step of the line kernel along the last axis of s2 (P, L,
    E): log2 sum_e 2^((s2 - c) + pot) with the lines' shifts c (P, L),
    which are reset to the line's max of s2 + pot on the first step and
    where that sum leaves [2^-64, 2^64). Returns (the log-sum, c)."""
    total = torch.exp2((s2 - c[:, :, None]) + pot[:, None, :]).sum(dim=2)
    reset = ~((total >= 2.0 ** -64) & (total < 2.0 ** 64))
    if first:
        reset = torch.ones_like(reset)
    mx = (s2 + pot[:, None, :]).amax(dim=2)
    fresh = torch.exp2((s2 - mx[:, :, None]) + pot[:, None, :]).sum(dim=2)
    c = torch.where(reset, mx, c)
    return c + torch.log2(torch.where(reset, fresh, total)), c


def sinkhorn_base2_plain(padded, log_mu, log_nu, num_iter: int):
    """sinkhorn_plain as the line kernel computes it: scores and marginals
    times log2 e, potentials in base 2, each line's log-sum-exp taken with
    a shift kept from step to step (`_lse2_shifted`), converted back at the
    output as (s + u2 ln 2) + v2 ln 2."""
    s2, mu2, nu2 = padded * LOG2E, log_mu * LOG2E, log_nu * LOG2E
    s2t = s2.transpose(1, 2)
    u2, v2 = torch.zeros_like(mu2), torch.zeros_like(nu2)
    cr, cc = torch.zeros_like(mu2), torch.zeros_like(nu2)
    for it in range(num_iter):
        lse, cr = _lse2_shifted(s2, cr, v2, it == 0)
        u2 = mu2 - lse
        lse, cc = _lse2_shifted(s2t, cc, u2, it == 0)
        v2 = nu2 - lse
    return (padded + u2[:, :, None] * LN2) + v2[:, None, :] * LN2


def _reverse(padded, log_mu, log_nu, g, num_iter: int, traj, split: bool):
    if traj is None:
        traj = _trajectory(padded, log_mu, log_nu, num_iter)
    else:
        traj = list(zip(traj[0].unbind(1), traj[1].unbind(1)))
    ds = g.clone()
    rows = cols = 0.0  # split: sum_t dv_t b_t and sum_t du_t a_t
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
        if split:
            rows = rows + dvb
        else:
            ds = ds - dvb
        du = du - dvb.sum(dim=2)
        a_t = torch.exp(padded + v_prev[:, None, :] - log_mu[:, :, None] + u_t[:, :, None])
        dmu = dmu + du
        dua = du[:, :, None] * a_t
        if split:
            cols = cols + dua
        else:
            ds = ds - dua
        dv = -dua.sum(dim=1)
        du = torch.zeros_like(du)
    return ((g - rows) - cols if split else ds), dmu, dnu


def sinkhorn_bwd_plain(padded, log_mu, log_nu, g, num_iter: int, traj=None):
    """Cotangent g of s + u + v -> (ds, dmu, dnu): the reverse loop of
    roitr_tpu `_sinkhorn_bwd_kernel`, with a_t / b_t the row / column
    softmaxes of step t. The u/v trajectory is recomputed, as the JAX
    package's VJP does, or taken from traj = (u (P, T, M1), v (P, T, N1))."""
    return _reverse(padded, log_mu, log_nu, g, num_iter, traj, split=False)


def sinkhorn_bwd_split_plain(padded, log_mu, log_nu, g, num_iter: int, traj=None):
    """sinkhorn_bwd_plain with ds formed as the line kernel forms it: the
    sum over steps of dv_t b_t (its row owners') and of du_t a_t (its column
    owners') kept apart, and ds = (g - the first) - the second at the end."""
    return _reverse(padded, log_mu, log_nu, g, num_iter, traj, split=True)


def _check(padded, log_mu, log_nu):
    dev = padded.device
    p, m1, n1 = padded.shape
    check_cuda(padded, "scores", torch.float32, (p, m1, n1), dev)
    check_cuda(log_mu, "log_mu", torch.float32, (p, m1), dev)
    check_cuda(log_nu, "log_nu", torch.float32, (p, n1), dev)
    return dev, p, m1, n1


def sinkhorn_iterate(padded, log_mu, log_nu, num_iter: int, with_traj: bool = False):
    """Same function and arguments as sinkhorn_plain; one kernel launch on
    the card, which writes the trajectory only with_traj."""
    if route(padded) == "plain":
        return sinkhorn_plain(padded, log_mu, log_nu, num_iter, with_traj)
    from roitr_torch.kernels.build import function

    dev, p, m1, n1 = _check(padded, log_mu, log_nu)
    out = torch.empty_like(padded)
    traj = [padded.new_empty((p, num_iter, m1)), padded.new_empty((p, num_iter, n1))] \
        if with_traj else []
    traj_ptrs = [ptr(t) for t in traj] if with_traj else [ctypes.c_void_p(None)] * 2
    fn = function("sinkhorn", "roitr_sinkhorn",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(padded), ptr(log_mu), ptr(log_nu), ptr(out), *traj_ptrs, p, m1, n1, num_iter,
             stream_ptr(dev))
    check_launch(err, "sinkhorn")
    launch_counts["sinkhorn"] += 1
    return (out, *traj) if with_traj else out


def sinkhorn_bwd(padded, log_mu, log_nu, g, num_iter: int, traj=None):
    """Same function and arguments as sinkhorn_bwd_plain; one call on the
    card. From the forward's trajectory traj = (u, v) it is one backward
    kernel launch; without it, the forward kernel first writes the
    trajectory into scratch, then the backward kernel reads it."""
    if route(padded) == "plain":
        return sinkhorn_bwd_plain(padded, log_mu, log_nu, g, num_iter, traj)
    from roitr_torch.kernels.build import function

    dev, p, m1, n1 = _check(padded, log_mu, log_nu)
    check_cuda(g, "g", torch.float32, (p, m1, n1), dev)
    make_traj = traj is None
    if make_traj:  # scratch; a num_iter below 1 is refused by the C entry
        traj = (padded.new_empty((p, max(num_iter, 0), m1)),
                padded.new_empty((p, max(num_iter, 0), n1)))
    else:
        check_cuda(traj[0], "traj_u", torch.float32, (p, num_iter, m1), dev)
        check_cuda(traj[1], "traj_v", torch.float32, (p, num_iter, n1), dev)
    ds = torch.empty_like(padded)
    dmu = torch.empty_like(log_mu)
    dnu = torch.empty_like(log_nu)
    fn = function("sinkhorn", "roitr_sinkhorn_bwd",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(padded), ptr(log_mu), ptr(log_nu), ptr(g), ptr(traj[0]), ptr(traj[1]),
             int(make_traj), ptr(ds), ptr(dmu), ptr(dnu), p, m1, n1, num_iter, stream_ptr(dev))
    check_launch(err, "sinkhorn_bwd")
    launch_counts["sinkhorn_bwd"] += 1
    return ds, dmu, dnu


class _Sinkhorn(torch.autograd.Function):
    """Applied only when a gradient is needed (`sinkhorn`). Forward:
    sinkhorn_iterate writing the trajectory, which it saves with its
    inputs; with kernel=False sinkhorn_plain, saving only its inputs
    (roitr_tpu `_vjp_fwd`). Backward: sinkhorn_bwd from the saved
    trajectory, or sinkhorn_bwd_plain, which recomputes it (the JAX
    package's checkpointed scan)."""

    @staticmethod
    def forward(ctx, padded, log_mu, log_nu, num_iter, kernel):
        ctx.num_iter = num_iter
        ctx.kernel = kernel
        if not kernel:
            ctx.save_for_backward(padded, log_mu, log_nu)
            return sinkhorn_plain(padded, log_mu, log_nu, num_iter)
        out, traj_u, traj_v = sinkhorn_iterate(padded, log_mu, log_nu, num_iter, with_traj=True)
        ctx.save_for_backward(padded, log_mu, log_nu, traj_u, traj_v)
        return out

    @staticmethod
    def backward(ctx, g):
        padded, log_mu, log_nu, *traj = ctx.saved_tensors
        if ctx.kernel:
            ds, dmu, dnu = sinkhorn_bwd(padded, log_mu, log_nu, g.contiguous(), ctx.num_iter,
                                        tuple(traj))
        else:
            ds, dmu, dnu = sinkhorn_bwd_plain(padded, log_mu, log_nu, g.contiguous(),
                                              ctx.num_iter)
        return ds, dmu, dnu, None, None


def sinkhorn(padded, log_mu, log_nu, num_iter: int, kernel: bool = True):
    """Differentiable sinkhorn_iterate; kernel=False takes the plain loop
    forward and backward, on whatever device the tensors are. Without grad
    mode, or without an input that needs a gradient, no trajectory is
    written."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (padded, log_mu, log_nu)):
        return _Sinkhorn.apply(padded, log_mu, log_nu, num_iter, kernel)
    return (sinkhorn_iterate if kernel else sinkhorn_plain)(padded, log_mu, log_nu, num_iter)
