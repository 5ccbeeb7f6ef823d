"""Fused global RPE self-attention and its backward (csrc/rpe_attention.cu).

Replaces roitr_tpu/ops/pallas/rpe_attention_kernel.py: `_kernel` via
`_pallas_forward` (scores (q.k + qwp_h.e_nm)/sqrt(c); hidden = masked
softmax @ v; ae_h = the self-excluding masked softmax @ e) and `_bwd_kernel`
via `_pallas_backward` (both softmaxes recomputed, then every gradient
product). The (N, N, D) embedding may be bf16 (storage) while everything
else is fp32; sums are fp32, and the embedding's gradient comes back in its
storage dtype. `rpe_attention` is the differentiable entry.

Both take a leading pair axis, as the TPU kernels do under the packed
path's vmap: (B, N, D) q/k/v, hidden and cotangent, (B, N, H, D) qwp, ae
and cotangent, (B, N, N, D) embedding, (B, N) key mask, (B, N, H)
log-sum-exps; one launch of each kernel for the B pairs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def supported_heads(h: int) -> bool:
    """Whether the kernels take h heads: their per-thread head arrays are
    sized for at most 16 (mirrors csrc/rpe_attention.cu `kMaxHeads` and the
    checks of `roitr_rpe_attention` and `roitr_rpe_attention_bwd_takes`)."""
    return 1 <= h <= 16


def supported_width(d: int) -> bool:
    """Whether the backward kernel takes width d: rows of the embedding in
    16-byte copies (mirrors the `d % 8` check of
    `roitr_rpe_attention_bwd_takes` in csrc/rpe_attention.cu)."""
    return d >= 8 and d % 8 == 0


def _scores(q2, k2, qwp, e, key_mask):
    """Scores (..., H, N, N) of the forward, e in q2's dtype, and the keep
    masks of the value softmax and of the self-excluding positional one."""
    n, d = q2.shape[-2:]
    lead = q2.shape[:-2]
    h = qwp.shape[-2]
    c = d // h
    scores_e = torch.einsum("...nhc,...mhc->...hnm", q2.reshape(*lead, n, h, c),
                            k2.reshape(*lead, n, h, c))
    scores_p = torch.einsum("...nhd,...nmd->...hnm", qwp, e)
    kmask = (key_mask > 0.0)[..., None, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=q2.device)
    return (scores_e + scores_p) / math.sqrt(c), kmask, kmask & ~eye


def _masked_lse(scores, keep):
    """(..., H, N, N) scores -> (..., N, H) log-sum-exp over the kept keys,
    as the kernel forms it (max + log of the shifted sum); +inf for a row
    with no kept key, so that exp(s - lse) is 0 for every key."""
    s = torch.where(keep, scores, torch.tensor(-float("inf"), device=scores.device))
    mx = torch.amax(s, dim=-1)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    tot = torch.exp(s - mx[..., None]).sum(dim=-1)
    lse = torch.where(tot > 0, mx + torch.log(tot), torch.full_like(tot, float("inf")))
    return lse.transpose(-1, -2).contiguous()


def rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask, with_lse: bool = False):
    """q2/k2/v2 (N, D), qwp (N, H, D), embed (N, N, D), key_mask (N,)
    float 1/0 -> hidden (N, D), ae (N, H, D) (roitr_tpu `xla_forward`);
    with_lse adds the (N, H) log-sum-exps of the value softmax and of the
    positional one (_masked_lse). Every argument and result may carry a
    leading pair axis (B, ...)."""
    from roitr_torch.models.attention import masked_softmax

    n, d = q2.shape[-2:]
    lead = q2.shape[:-2]
    h = qwp.shape[-2]
    e = embed.to(q2.dtype)
    scores, keep, keep_pos = _scores(q2, k2, qwp, e, key_mask)
    attn, attn_pos = masked_softmax(scores, keep), masked_softmax(scores, keep_pos)
    hidden = torch.einsum("...hnm,...mhc->...nhc", attn,
                          v2.reshape(*lead, n, h, d // h)).reshape(*lead, n, d)
    ae = torch.einsum("...hnm,...nmd->...nhd", attn_pos, e)
    if with_lse:
        return hidden, ae, _masked_lse(scores, keep), _masked_lse(scores, keep_pos)
    return hidden, ae


def rpe_attention_bwd_plain(q2, k2, v2, qwp, embed, key_mask, ghid, gae):
    """Cotangents ghid (N, D), gae (N, H, D) -> (dq2, dk2, dv2, dqwp, dembed),
    dembed in embed's dtype: the products of roitr_tpu `_bwd_kernel`. Every
    argument and result may carry a leading pair axis (B, ...)."""
    from roitr_torch.models.attention import masked_softmax

    n, d = q2.shape[-2:]
    lead = q2.shape[:-2]
    h = qwp.shape[-2]
    c = d // h
    e = embed.to(q2.dtype)
    scores, keep, keep_pos = _scores(q2, k2, qwp, e, key_mask)
    attn, attn_pos = masked_softmax(scores, keep), masked_softmax(scores, keep_pos)
    heads = lambda t: t.reshape(*lead, n, h, c)  # noqa: E731
    gh = heads(ghid)
    dv = torch.einsum("...hnm,...nhc->...mhc", attn, gh).reshape(*lead, n, d)
    d_attn = torch.einsum("...nhc,...mhc->...hnm", gh, heads(v2))
    ds = attn * (d_attn - (attn * d_attn).sum(dim=-1, keepdim=True))
    d_ap = torch.einsum("...nhd,...nmd->...hnm", gae, e)
    ds = ds + attn_pos * (d_ap - (attn_pos * d_ap).sum(dim=-1, keepdim=True))
    ds = ds / math.sqrt(c)
    dq = torch.einsum("...hnm,...mhc->...nhc", ds, heads(k2)).reshape(*lead, n, d)
    dk = torch.einsum("...hnm,...nhc->...mhc", ds, heads(q2)).reshape(*lead, n, d)
    dqwp = torch.einsum("...hnm,...nmd->...nhd", ds, e)
    demb = (torch.einsum("...hnm,...nhd->...nmd", attn_pos, gae)
            + torch.einsum("...hnm,...nhd->...nmd", ds, qwp))
    return dq, dk, dv, dqwp, demb.to(embed.dtype)


def rpe_attention_bwd_onepass_plain(q2, k2, v2, qwp, embed, key_mask, ghid, gae, hidden, ae,
                                    lse_attn, lse_pos):
    """Same result as rpe_attention_bwd_plain, by csrc/rpe_attention.cu's
    one-pass algorithm: given the forward's hidden, ae and log-sum-exps,
    each probability is exp(score - lse), masked, and the softmax VJPs' row
    sums are ghid_h . hidden_h and gae_h . ae_h, so no sum over the keys
    precedes ds. Emulates the kernel's algorithm on any device; the tests
    use it, the model does not."""
    n, d = q2.shape
    h = qwp.shape[1]
    c = d // h
    e = embed.to(q2.dtype)
    scores, keep, keep_pos = _scores(q2, k2, qwp, e, key_mask)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    p_attn = torch.where(keep, torch.exp(scores - lse_attn.t()[:, :, None]), zero)
    p_pos = torch.where(keep_pos, torch.exp(scores - lse_pos.t()[:, :, None]), zero)
    gh = ghid.reshape(n, h, c)
    row_attn = (gh * hidden.reshape(n, h, c)).sum(dim=-1).t()[:, :, None]  # (H, N, 1)
    row_pos = (gae * ae).sum(dim=-1).t()[:, :, None]
    d_attn = torch.einsum("nhc,mhc->hnm", gh, v2.reshape(n, h, c))
    d_ap = torch.einsum("nhd,nmd->hnm", gae, e)
    ds = (p_attn * (d_attn - row_attn) + p_pos * (d_ap - row_pos)) / math.sqrt(c)
    dq = torch.einsum("hnm,mhc->nhc", ds, k2.reshape(n, h, c)).reshape(n, d)
    dk = torch.einsum("hnm,nhc->mhc", ds, q2.reshape(n, h, c)).reshape(n, d)
    dv = torch.einsum("hnm,nhc->mhc", p_attn, gh).reshape(n, d)
    dqwp = torch.einsum("hnm,nmd->nhd", ds, e)
    demb = torch.einsum("hnm,nhd->nmd", p_pos, gae) + torch.einsum("hnm,nhd->nmd", ds, qwp)
    return dq, dk, dv, dqwp, demb.to(embed.dtype)


def _check(q2, k2, v2, qwp, embed, key_mask):
    """(device, lead, n, d, h): every argument on one card, contiguous, of
    its dtype and shape; `lead` is () for one pair, (B,) for a batch."""
    dev = q2.device
    n, d = q2.shape[-2:]
    lead = tuple(q2.shape[:-2])
    h = qwp.shape[-2]
    if len(lead) > 1:
        raise ValueError(f"rpe_attention: q2 of shape {tuple(q2.shape)}, expected (N, D) or "
                         "(B, N, D)")
    if embed.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rpe_attention: embedding dtype {embed.dtype} not fp32 or bf16")
    for t, name, shape in ((q2, "q2", (n, d)), (k2, "k2", (n, d)), (v2, "v2", (n, d)),
                           (qwp, "qwp", (n, h, d)), (key_mask, "key_mask", (n,))):
        check_cuda(t, name, torch.float32, lead + shape, dev)
    check_cuda(embed, "embed", embed.dtype, lead + (n, n, d), dev)
    return dev, lead, n, d, h


def fused_rpe_self_attention(q2, k2, v2, qwp, embed, key_mask, with_lse: bool = False):
    """Same function and arguments as rpe_attention_plain; one kernel
    launch on the card, for one pair or a leading pair axis of B, which
    writes the log-sum-exps only with_lse."""
    if route(q2) == "plain":
        return rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask, with_lse)
    from roitr_torch.kernels.build import function

    dev, lead, n, d, h = _check(q2, k2, v2, qwp, embed, key_mask)
    f32 = dict(dtype=torch.float32, device=dev)
    hidden = torch.empty(lead + (n, d), **f32)
    ae = torch.empty(lead + (n, h, d), **f32)
    lse = [torch.empty(lead + (n, h), **f32) for _ in range(2)] if with_lse else []
    fn = function("rpe_attention", "roitr_rpe_attention",
                  [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lse_ptrs = [ptr(t) for t in lse] if with_lse else [ctypes.c_void_p(None)] * 2
    err = fn(ptr(q2), ptr(k2), ptr(v2), ptr(qwp), ptr(embed), ptr(key_mask), ptr(hidden),
             ptr(ae), *lse_ptrs, lead[0] if lead else 1, n, d, h,
             int(embed.dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "rpe_attention")
    launch_counts["rpe_attention"] += 1
    return (hidden, ae, *lse) if with_lse else (hidden, ae)


def rpe_attention_bwd(q2, k2, v2, qwp, embed, key_mask, ghid, gae, hidden=None, ae=None,
                      lse_attn=None, lse_pos=None):
    """Same function and arguments as rpe_attention_bwd_plain, plus the
    forward's outputs and log-sum-exps (fused_rpe_self_attention with_lse;
    run here if not given). On the card one launch of the backward kernels,
    for one pair or a leading pair axis of B: the per-head products q.k and
    ghid.v, the one-pass row kernel over the embedding, and the products
    that give dq, dk and dv."""
    if route(q2) == "plain":
        return rpe_attention_bwd_plain(q2, k2, v2, qwp, embed, key_mask, ghid, gae)
    from roitr_torch.kernels.build import function

    dev, lead, n, d, h = _check(q2, k2, v2, qwp, embed, key_mask)
    b = lead[0] if lead else 1
    check_launch(function("rpe_attention", "roitr_rpe_attention_bwd_takes",
                          [ctypes.c_int] * 4)(b, n, d, h), "rpe_attention_bwd")
    if hidden is None:
        hidden, ae, lse_attn, lse_pos = fused_rpe_self_attention(q2, k2, v2, qwp, embed,
                                                                 key_mask, with_lse=True)
    for t, name, shape in ((ghid, "ghid", (n, d)), (gae, "gae", (n, h, d)),
                           (hidden, "hidden", (n, d)), (ae, "ae", (n, h, d)),
                           (lse_attn, "lse_attn", (n, h)), (lse_pos, "lse_pos", (n, h))):
        check_cuda(t, name, torch.float32, lead + shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty(lead + (n, d), **f32) for _ in range(3))
    dqwp = torch.empty(lead + (n, h, d), **f32)
    demb = torch.empty_like(embed)
    scratch = torch.empty(function("rpe_attention", "roitr_rpe_attention_bwd_scratch_floats",
                                   [ctypes.c_int] * 4, ctypes.c_longlong)(b, n, d, h), **f32)
    fn = function("rpe_attention", "roitr_rpe_attention_bwd",
                  [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(ptr(q2), ptr(k2), ptr(v2), ptr(qwp), ptr(embed), ptr(key_mask), ptr(ghid), ptr(gae),
             ptr(hidden), ptr(ae), ptr(lse_attn), ptr(lse_pos), ptr(dq), ptr(dk), ptr(dv),
             ptr(dqwp), ptr(demb), ptr(scratch), b, n, d, h, int(embed.dtype == torch.bfloat16),
             stream_ptr(dev))
    check_launch(err, "rpe_attention_bwd")
    launch_counts["rpe_attention_bwd"] += 1
    return dq, dk, dv, dqwp, demb


class _RPEAttention(torch.autograd.Function):
    """Forward: fused_rpe_self_attention with the log-sum-exps (roitr_tpu
    `_fwd`); saves its inputs, outputs and log-sum-exps. Backward:
    rpe_attention_bwd; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v2, qwp, embed, key_mask):
        hidden, ae, lse_attn, lse_pos = fused_rpe_self_attention(q2, k2, v2, qwp, embed,
                                                                 key_mask, with_lse=True)
        ctx.save_for_backward(q2, k2, v2, qwp, embed, key_mask, hidden, ae, lse_attn, lse_pos)
        return hidden, ae

    @staticmethod
    def backward(ctx, ghid, gae):
        q2, k2, v2, qwp, embed, key_mask, hidden, ae, lse_attn, lse_pos = ctx.saved_tensors
        dq, dk, dv, dqwp, demb = rpe_attention_bwd(
            q2, k2, v2, qwp, embed, key_mask, ghid.contiguous(), gae.contiguous(), hidden, ae,
            lse_attn, lse_pos)
        return dq, dk, dv, dqwp, demb, None


def rpe_attention(q2, k2, v2, qwp, embed, key_mask):
    """Differentiable fused_rpe_self_attention. Without grad mode, or without
    an input that needs a gradient, no log-sum-exp is written."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q2, k2, v2, qwp, embed)):
        return _RPEAttention.apply(q2, k2, v2, qwp, embed, key_mask)
    return fused_rpe_self_attention(q2, k2, v2, qwp, embed, key_mask)
