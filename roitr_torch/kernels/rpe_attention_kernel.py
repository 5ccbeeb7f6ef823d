"""Fused global RPE self-attention (csrc/rpe_attention.cu).

Replaces roitr_tpu/ops/pallas/rpe_attention_kernel.py `_kernel` via
`_pallas_forward` / `fused_rpe_self_attention`. Scores
(q.k + qwp_h.e_nm)/sqrt(c); hidden = masked softmax @ v; ae_h = the
self-excluding masked softmax @ e. The (N, N, D) embedding may be bf16
(storage) while everything else is fp32; sums are fp32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roitr_torch.kernels import check_cuda, check_launch, launch_counts, ptr, route, stream_ptr


def rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask):
    """q2/k2/v2 (N, D), qwp (N, H, D), embed (N, N, D), key_mask (N,)
    float 1/0 -> hidden (N, D), ae (N, H, D) (roitr_tpu `xla_forward`)."""
    from roitr_torch.models.attention import masked_softmax

    n, d = q2.shape
    h = qwp.shape[1]
    c = d // h
    q = q2.reshape(n, h, c)
    k = k2.reshape(n, h, c)
    v = v2.reshape(n, h, c)
    scores_e = torch.einsum("nhc,mhc->hnm", q, k)
    scores_p = torch.einsum("nhd,nmd->hnm", qwp, embed.float())
    scores = (scores_e + scores_p) / math.sqrt(c)
    kmask = (key_mask > 0.0)[None, None, :]
    attn = masked_softmax(scores, kmask)
    hidden = torch.einsum("hnm,mhc->nhc", attn, v).reshape(n, d)
    eye = torch.eye(n, dtype=torch.bool, device=q2.device)[None]
    attn_pos = masked_softmax(scores, kmask & ~eye)
    ae = torch.einsum("hnm,nmd->nhd", attn_pos, embed.float())
    return hidden, ae


def fused_rpe_self_attention(q2, k2, v2, qwp, embed, key_mask):
    """Same function and arguments as rpe_attention_plain; one kernel
    launch on the card."""
    if route(q2) == "plain":
        return rpe_attention_plain(q2, k2, v2, qwp, embed, key_mask)
    from roitr_torch.kernels.build import function

    dev = q2.device
    n, d = q2.shape
    h = qwp.shape[1]
    if embed.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rpe_attention: embedding dtype {embed.dtype} not fp32 or bf16")
    for t, name, shape in ((q2, "q2", (n, d)), (k2, "k2", (n, d)), (v2, "v2", (n, d)),
                           (qwp, "qwp", (n, h, d)), (key_mask, "key_mask", (n,))):
        check_cuda(t, name, torch.float32, shape, dev)
    check_cuda(embed, "embed", embed.dtype, (n, n, d), dev)
    hidden = torch.empty((n, d), dtype=torch.float32, device=dev)
    ae = torch.empty((n, h, d), dtype=torch.float32, device=dev)
    fn = function("rpe_attention", "roitr_rpe_attention",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(ptr(q2), ptr(k2), ptr(v2), ptr(qwp), ptr(embed), ptr(key_mask), ptr(hidden),
             ptr(ae), n, d, h, int(embed.dtype == torch.bfloat16), stream_ptr(dev))
    check_launch(err, "rpe_attention")
    launch_counts["rpe_attention"] += 1
    return hidden, ae
