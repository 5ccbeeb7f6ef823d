"""Fused geometric structure embedding and its backward (csrc/geo_embedding.cu).

Replaces roitr_tpu/ops/pallas/geo_embedding_kernel.py: `_kernel` via
`_pallas_forward`,

    out = [sin(d w), cos(d w)] @ Wd + bd + max_k([sin(a_k w), cos(a_k w)] @ Wa) + ba

for every flattened node pair, with the interleaved sinusoidal basis of
models/embeddings.py (the kernel never builds the (R, k, H) basis and
writes the output once, in the storage dtype; under differentiation it also
writes the int8 (R, H) map of the winning k), and `_bwd_kernel` via
`_pallas_backward` (the weight gradients from the map and the cotangent,
dba = dbd; the indices get none). `geo_embedding` is the differentiable
entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def supported_k(k: int) -> bool:
    """Whether the forward kernel takes k angle neighbours: the argmax map
    is int8 (mirrors csrc/geo_embedding.cu:816, `roitr_geo_embedding`)."""
    return 1 <= k <= 127


def div_term(hidden: int, device=None) -> torch.Tensor:
    """Frequencies exp(-2i log(1e4) / hidden) of the sinusoidal basis, fp32
    (reference positional_encoding.py:38-62)."""
    return torch.exp(torch.arange(0, hidden, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / hidden))


def sinusoidal_basis(x: torch.Tensor, hidden: int) -> torch.Tensor:
    """x (*,) -> (*, hidden) interleaved [sin0, cos0, sin1, cos1, ...]."""
    om = x[..., None] * div_term(hidden, x.device)
    return torch.stack([torch.sin(om), torch.cos(om)], dim=-1).reshape(x.shape + (hidden,))


def geo_embedding_plain(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32,
                        with_argmax: bool = False):
    """d_idx (R,), a_idx (R, k), wd/wa (H, H) (in, out), bd/ba (H,) ->
    (R, H) in out_dtype, and with_argmax the (R, H) int8 first winning k;
    math in the weights' dtype (roitr_tpu `_xla_forward`)."""
    hidden = wd.shape[1]
    y = sinusoidal_basis(d_idx, hidden) @ wd + bd
    ya = sinusoidal_basis(a_idx, hidden) @ wa  # (R, k, H)
    out = (y + torch.amax(ya, dim=-2) + ba).to(out_dtype)
    if with_argmax:
        return out, torch.argmax(ya, dim=-2).to(torch.int8)  # first maximum
    return out


def split_bf16(x: torch.Tensor):
    """x (fp32) -> (hi, lo) bf16 with hi = bf16(x), lo = bf16(x - hi): hi + lo
    carries about 16 of fp32's 24 significand bits."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_product(e: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """e @ w as the kernel's tensor cores take it: hi.hi + hi.lo + lo.hi of the
    split operands (each bf16 product exact in fp32), summed in fp32."""
    e_hi, e_lo = (t.float() for t in split_bf16(e))
    w_hi, w_lo = (t.float() for t in split_bf16(w))
    return e_hi @ w_hi + e_hi @ w_lo + e_lo @ w_hi


def geo_embedding_split_plain(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32,
                              with_argmax: bool = False):
    """Same function and arguments as geo_embedding_plain, with its products
    taken as csrc/geo_embedding.cu takes them (three split-bf16 products,
    fp32 sums). Emulates the kernel's numerics on any device; the tests and
    chip_smoke.py use it, the model does not."""
    hidden = wd.shape[1]
    y = _split_product(sinusoidal_basis(d_idx, hidden), wd) + bd
    ya = _split_product(sinusoidal_basis(a_idx, hidden), wa)  # (R, k, H)
    out = (y + torch.amax(ya, dim=-2) + ba).to(out_dtype)
    if with_argmax:
        return out, torch.argmax(ya, dim=-2).to(torch.int8)
    return out


def geo_embedding_bwd_plain(d_idx, a_idx, amax, g, hidden: int):
    """Cotangent g (R, H) and the argmax map -> (dwd, dbd, dwa), dba == dbd
    (roitr_tpu `_pallas_backward`); math in fp32, or in g's dtype if wider."""
    dt = torch.promote_types(g.dtype, torch.float32)
    g = g.to(dt)
    dwd = sinusoidal_basis(d_idx.to(dt), hidden).t() @ g
    e_a = sinusoidal_basis(a_idx.to(dt), hidden)  # (R, k, H)
    k = a_idx.shape[1]
    sel = amax.long()[:, None, :] == torch.arange(k, device=g.device)[None, :, None]  # (R, k, H)
    dwa = torch.einsum("rkh,rkd->dh", sel.to(dt) * g[:, None, :], e_a)
    return dwd, g.sum(dim=0), dwa


def geo_embedding_bwd_split_plain(d_idx, a_idx, amax, g, hidden: int):
    """Same function and arguments as geo_embedding_bwd_plain (g fp32 or
    bf16), with its products taken as csrc/geo_embedding.cu's backward takes
    them: the basis split into bf16 hi + lo, the cotangent split only when it
    is fp32 (a bf16 g is its own hi, its lo zero), masked per phase, fp32
    sums. Emulates the kernel's numerics on any device; the tests and
    chip_smoke.py use it, the model does not."""
    g_hi, g_lo = (t.float() for t in split_bf16(g.float()))

    def product(e, mask=None):  # e^T (g * mask): lo.hi + hi.lo + hi.hi
        e_hi, e_lo = (t.float() for t in split_bf16(e))
        gh, gl = (g_hi, g_lo) if mask is None else (g_hi * mask, g_lo * mask)
        return e_lo.t() @ gh + e_hi.t() @ gl + e_hi.t() @ gh

    dwd = product(sinusoidal_basis(d_idx.float(), hidden))
    e_a = sinusoidal_basis(a_idx.float(), hidden)  # (R, k, H)
    dwa = sum(product(e_a[:, q], (amax == q).float()) for q in range(a_idx.shape[1]))
    return dwd, g.float().sum(dim=0), dwa


def _kernel_args(d_idx, a_idx, hidden: int, wd=None, bd=None, wa=None, ba=None):
    """The kernels' checked fp32 inputs: indices, frequencies and, for the
    forward, the even / odd rows of the (in, out) weights
    (e @ W == sin @ W[0::2] + cos @ W[1::2]) and the biases."""
    dev = d_idx.device
    r, k = a_idx.shape
    if hidden % 2 or k < 1 or (wd is not None and tuple(wd.shape) != (hidden, hidden)):
        raise ValueError(f"geo_embedding: hidden {hidden} must be even, wd square, k >= 1 "
                         f"(got hidden {hidden}, k {k})")
    h2 = hidden // 2
    args = [(d_idx, "d_idx", (r,)), (a_idx, "a_idx", (r, k)), (div_term(hidden, dev), "div", (h2,))]
    if wd is not None:
        args += [(wd[0::2].contiguous(), "wd[0::2]", (h2, hidden)),
                 (wd[1::2].contiguous(), "wd[1::2]", (h2, hidden)), (bd, "bd", (hidden,)),
                 (wa[0::2].contiguous(), "wa[0::2]", (h2, hidden)),
                 (wa[1::2].contiguous(), "wa[1::2]", (h2, hidden)), (ba, "ba", (hidden,))]
    for t, name, shape in args:
        check_cuda(t, name, torch.float32, shape, dev)
    return [t for t, _, _ in args]


def fused_geo_embedding(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32,
                        with_argmax: bool = False):
    """Same function and arguments as geo_embedding_plain; on the card one
    launch of the weight split and the tensor-core kernel, whose products
    geo_embedding_split_plain emulates."""
    if route(d_idx) == "plain":
        return geo_embedding_plain(d_idx, a_idx, wd, bd, wa, ba, out_dtype, with_argmax)
    from roitr_torch.kernels.build import function

    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"geo_embedding: out_dtype {out_dtype} not fp32 or bf16")
    r, k = a_idx.shape
    hidden = wd.shape[1]
    args = _kernel_args(d_idx, a_idx, hidden, wd, bd, wa, ba)
    dev = d_idx.device
    out = torch.empty((r, hidden), dtype=out_dtype, device=dev)
    amax = torch.empty((r, hidden), dtype=torch.int8, device=dev) if with_argmax else None
    # the weights split into bf16 hi / lo by the launch, in the kernel's layout
    wsplit = torch.empty(function("geo_embedding", "roitr_geo_embedding_wsplit_elems",
                                  [ctypes.c_int])(hidden), dtype=torch.bfloat16, device=dev)
    fn = function("geo_embedding", "roitr_geo_embedding",
                  [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(*(ptr(t) for t in args), ptr(out),
             ptr(amax) if with_argmax else ctypes.c_void_p(None), ptr(wsplit), r, k, hidden,
             int(out_dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "geo_embedding")
    launch_counts["geo_embedding"] += 1
    return (out, amax) if with_argmax else out


# blocks of the backward's row reduction: two waves of the H100's 132 SMs at
# one block an SM
_BWD_TARGET_BLOCKS = 264


def geo_embedding_bwd(d_idx, a_idx, amax, g, hidden: int):
    """Same function and arguments as geo_embedding_bwd_plain; on the card one
    launch of the tensor-core backward kernel, whose products
    geo_embedding_bwd_split_plain emulates, and its chunk-ordered reduction."""
    if route(d_idx) == "plain":
        return geo_embedding_bwd_plain(d_idx, a_idx, amax, g, hidden)
    from roitr_torch.kernels.build import function

    dev = d_idx.device
    r, k = a_idx.shape
    d_idx, a_idx, div = _kernel_args(d_idx, a_idx, hidden)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"geo_embedding_bwd: cotangent dtype {g.dtype} not fp32 or bf16")
    check_cuda(g, "g", g.dtype, (r, hidden), dev)
    check_cuda(amax, "amax", torch.int8, (r, hidden), dev)
    h2 = hidden // 2
    # the kernel's output tiles: 32 frequencies (64 basis rows) x 256 columns
    tiles = -(-h2 // 32) * -(-hidden // 256)
    chunks = max(1, min(-(-_BWD_TARGET_BLOCKS // tiles), -(-r // 32)))
    part = torch.empty((chunks, 4, h2, hidden), dtype=torch.float32, device=dev)
    part_db = torch.empty((chunks, hidden), dtype=torch.float32, device=dev)
    dw = torch.empty((4, h2, hidden), dtype=torch.float32, device=dev)
    db = torch.empty((hidden,), dtype=torch.float32, device=dev)
    fn = function("geo_embedding", "roitr_geo_embedding_bwd",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(ptr(d_idx), ptr(a_idx), ptr(amax), ptr(g), ptr(div), ptr(part), ptr(part_db),
             ptr(dw), ptr(db), r, k, hidden, chunks, int(g.dtype == torch.bfloat16),
             stream_ptr(dev))
    check_launch(err, "geo_embedding_bwd")
    launch_counts["geo_embedding_bwd"] += 1
    # re-interleave the even/odd rows: W[0::2] <- dw[0], W[1::2] <- dw[1]
    dwd = torch.stack([dw[0], dw[1]], dim=1).reshape(hidden, hidden)
    dwa = torch.stack([dw[2], dw[3]], dim=1).reshape(hidden, hidden)
    return dwd, db, dwa


class _GeoEmbedding(torch.autograd.Function):
    """Forward: fused_geo_embedding with the argmax map (roitr_tpu `_fwd`);
    saves the indices and the map. Backward: geo_embedding_bwd."""

    @staticmethod
    def forward(ctx, d_idx, a_idx, wd, bd, wa, ba, out_dtype):
        out, amax = fused_geo_embedding(d_idx, a_idx, wd, bd, wa, ba, out_dtype,
                                        with_argmax=True)
        ctx.hidden = wd.shape[1]
        ctx.save_for_backward(d_idx, a_idx, amax)
        ctx.mark_non_differentiable(amax)
        return out, amax

    @staticmethod
    def backward(ctx, g, _):
        d_idx, a_idx, amax = ctx.saved_tensors
        dwd, dbd, dwa = geo_embedding_bwd(d_idx, a_idx, amax, g.contiguous(), ctx.hidden)
        return None, None, dwd, dbd, dwa, dbd, None


def geo_embedding(d_idx, a_idx, wd, bd, wa, ba, out_dtype=torch.float32):
    """Differentiable fused_geo_embedding. Without grad mode, or without a
    weight that needs a gradient, no argmax map is written."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wd, bd, wa, ba)):
        return _GeoEmbedding.apply(d_idx, a_idx, wd, bd, wa, ba, out_dtype)[0]
    return fused_geo_embedding(d_idx, a_idx, wd, bd, wa, ba, out_dtype)
