"""Fused global RPE self-attention and its backward (csrc/rpe_attention.cu).

Replaces roitr_tpu/ops/pallas/rpe_attention_kernel.py: `_kernel` via
`_pallas_forward` (scores (q.k + qwp_h.e_nm)/sqrt(c); hidden = masked
softmax @ v; ae_h = the self-excluding masked softmax @ e) and `_bwd_kernel`
via `_pallas_backward` (both softmaxes recomputed, then every gradient
product). The (N, N, D) embedding may be bf16 (storage) while everything
else is fp32; sums are fp32, and the embedding's gradient comes back in its
storage dtype. `rpe_attention` is the differentiable entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def _softmaxes(q2, k2, qwp, e, key_mask):
    """Both masked softmaxes (H, N, N) of the forward, e in q2's dtype."""
    from roitr_torch.models.attention import masked_softmax

    n, d = q2.shape
    h = qwp.shape[1]
    c = d // h
    scores_e = torch.einsum("nhc,mhc->hnm", q2.reshape(n, h, c), k2.reshape(n, h, c))
    scores_p = torch.einsum("nhd,nmd->hnm", qwp, e)
    scores = (scores_e + scores_p) / math.sqrt(c)
    kmask = (key_mask > 0.0)[None, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=q2.device)[None]
    return masked_softmax(scores, kmask), masked_softmax(scores, kmask & ~eye)


def rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask):
    """q2/k2/v2 (N, D), qwp (N, H, D), embed (N, N, D), key_mask (N,)
    float 1/0 -> hidden (N, D), ae (N, H, D) (roitr_tpu `xla_forward`)."""
    n, d = q2.shape
    h = qwp.shape[1]
    e = embed.to(q2.dtype)
    attn, attn_pos = _softmaxes(q2, k2, qwp, e, key_mask)
    hidden = torch.einsum("hnm,mhc->nhc", attn, v2.reshape(n, h, d // h)).reshape(n, d)
    ae = torch.einsum("hnm,nmd->nhd", attn_pos, e)
    return hidden, ae


def rpe_attention_bwd_plain(q2, k2, v2, qwp, embed, key_mask, ghid, gae):
    """Cotangents ghid (N, D), gae (N, H, D) -> (dq2, dk2, dv2, dqwp, dembed),
    dembed in embed's dtype: the products of roitr_tpu `_bwd_kernel`."""
    n, d = q2.shape
    h = qwp.shape[1]
    c = d // h
    e = embed.to(q2.dtype)
    attn, attn_pos = _softmaxes(q2, k2, qwp, e, key_mask)
    gh = ghid.reshape(n, h, c)
    dv = torch.einsum("hnm,nhc->mhc", attn, gh).reshape(n, d)
    d_attn = torch.einsum("nhc,mhc->hnm", gh, v2.reshape(n, h, c))
    ds = attn * (d_attn - (attn * d_attn).sum(dim=-1, keepdim=True))
    d_ap = torch.einsum("nhd,nmd->hnm", gae, e)
    ds = ds + attn_pos * (d_ap - (attn_pos * d_ap).sum(dim=-1, keepdim=True))
    ds = ds / math.sqrt(c)
    dq = torch.einsum("hnm,mhc->nhc", ds, k2.reshape(n, h, c)).reshape(n, d)
    dk = torch.einsum("hnm,nhc->mhc", ds, q2.reshape(n, h, c)).reshape(n, d)
    dqwp = torch.einsum("hnm,nmd->nhd", ds, e)
    demb = torch.einsum("hnm,nhd->nmd", attn_pos, gae) + torch.einsum("hnm,nhd->nmd", ds, qwp)
    return dq, dk, dv, dqwp, demb.to(embed.dtype)


def _check(q2, k2, v2, qwp, embed, key_mask):
    dev = q2.device
    n, d = q2.shape
    h = qwp.shape[1]
    if embed.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rpe_attention: embedding dtype {embed.dtype} not fp32 or bf16")
    for t, name, shape in ((q2, "q2", (n, d)), (k2, "k2", (n, d)), (v2, "v2", (n, d)),
                           (qwp, "qwp", (n, h, d)), (key_mask, "key_mask", (n,))):
        check_cuda(t, name, torch.float32, shape, dev)
    check_cuda(embed, "embed", embed.dtype, (n, n, d), dev)
    return dev, n, d, h


def fused_rpe_self_attention(q2, k2, v2, qwp, embed, key_mask):
    """Same function and arguments as rpe_attention_plain; one kernel
    launch on the card."""
    if route(q2) == "plain":
        return rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask)
    from roitr_torch.kernels.build import function

    dev, n, d, h = _check(q2, k2, v2, qwp, embed, key_mask)
    hidden = torch.empty((n, d), dtype=torch.float32, device=dev)
    ae = torch.empty((n, h, d), dtype=torch.float32, device=dev)
    fn = function("rpe_attention", "roitr_rpe_attention",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(q2), ptr(k2), ptr(v2), ptr(qwp), ptr(embed), ptr(key_mask), ptr(hidden),
             ptr(ae), n, d, h, int(embed.dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "rpe_attention")
    launch_counts["rpe_attention"] += 1
    return hidden, ae


def rpe_attention_bwd(q2, k2, v2, qwp, embed, key_mask, ghid, gae):
    """Same function and arguments as rpe_attention_bwd_plain; one launch
    of the two backward kernels on the card (rows, then the dk/dv
    reduction over rows)."""
    if route(q2) == "plain":
        return rpe_attention_bwd_plain(q2, k2, v2, qwp, embed, key_mask, ghid, gae)
    from roitr_torch.kernels.build import function

    dev, n, d, h = _check(q2, k2, v2, qwp, embed, key_mask)
    check_cuda(ghid, "ghid", torch.float32, (n, d), dev)
    check_cuda(gae, "gae", torch.float32, (n, h, d), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty((n, d), **f32) for _ in range(3))
    dqwp = torch.empty((n, h, d), **f32)
    demb = torch.empty_like(embed)
    ds_scratch = torch.empty((n, h, n), **f32)
    attn_scratch = torch.empty((n, h, n), **f32)
    fn = function("rpe_attention", "roitr_rpe_attention_bwd",
                  [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(q2), ptr(k2), ptr(v2), ptr(qwp), ptr(embed), ptr(key_mask), ptr(ghid), ptr(gae),
             ptr(dq), ptr(dk), ptr(dv), ptr(dqwp), ptr(demb), ptr(ds_scratch), ptr(attn_scratch),
             n, d, h, int(embed.dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "rpe_attention_bwd")
    launch_counts["rpe_attention_bwd"] += 1
    return dq, dk, dv, dqwp, demb


class _RPEAttention(torch.autograd.Function):
    """Forward: fused_rpe_self_attention; saves its inputs (roitr_tpu
    `_fwd`). Backward: rpe_attention_bwd; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v2, qwp, embed, key_mask):
        ctx.save_for_backward(q2, k2, v2, qwp, embed, key_mask)
        return fused_rpe_self_attention(q2, k2, v2, qwp, embed, key_mask)

    @staticmethod
    def backward(ctx, ghid, gae):
        q2, k2, v2, qwp, embed, key_mask = ctx.saved_tensors
        dq, dk, dv, dqwp, demb = rpe_attention_bwd(
            q2, k2, v2, qwp, embed, key_mask, ghid.contiguous(), gae.contiguous())
        return dq, dk, dv, dqwp, demb, None


def rpe_attention(q2, k2, v2, qwp, embed, key_mask):
    """Differentiable fused_rpe_self_attention."""
    return _RPEAttention.apply(q2, k2, v2, qwp, embed, key_mask)
