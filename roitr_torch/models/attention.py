"""Attention layers: local PPF attention, global RPE self attention with
learned positional states, and cross attention.

Counterpart of roitr_tpu/models/attention.py (reference
model/transformer/{attention,geoattention}.py). As in the JAX package, the
global RPE attention never builds the projected (N, N, d) positional
tensors: q . proj_p(e) is computed as (q W_p) . e and sum_m A proj_vp(e)
as proj_vp(sum_m A e), and the (N, N, d) embedding is read by one kernel
per layer (kernels/rpe_attention_kernel.py), and by another in the
backward. Softmaxes are mask-safe: a row with no valid key gives zeros.
Module attribute paths follow the reference state_dict layout.

`dtype` is the compute dtype, as flax's `dtype` in the JAX package: every
Linear and LayerNorm computes in it from fp32 parameters
(models/layers.py). Under bf16 compute the RPE attention kernels still
take fp32 q, k, v and q W_p, and the positional states leave the attention
in fp32, where the JAX package's mixed bf16 x fp32 products promote.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from roitr_torch.kernels.rpe_attention_kernel import (
    rpe_attention,
    rpe_attention_plain,
    supported_heads,
    supported_width,
)
from roitr_torch.models.embeddings import PPFEmbedding
from roitr_torch.models.layers import LayerNorm, Linear


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1):
    """softmax along `dim` in the scores' dtype; `mask` True = keep.
    All-masked rows -> zeros."""
    if mask is not None:
        scores = torch.where(mask, scores, -math.inf)
    m = torch.amax(scores, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)


@functools.lru_cache(maxsize=None)
def _scale(c: int, dtype) -> float:
    """The scores' divisor sqrt(c) as the JAX package takes it: rounded to
    the compute dtype."""
    return torch.tensor(math.sqrt(c), dtype=dtype).item()


class AttentionOutput(nn.Module):
    """Feed-forward block: expand 2x, relu, squeeze, residual LayerNorm
    (reference attention.py:203-218)."""

    def __init__(self, d_model: int, dtype=torch.float32):
        super().__init__()
        self.expand = Linear(d_model, 2 * d_model, dtype)
        self.squeeze = Linear(2 * d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


def _projections(d_model: int, names, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({name: Linear(d_model, d_model, dtype) for name in names})


class LocalPPFAttention(nn.Module):
    """Gathered neighborhood attention with PPF relative position terms
    (reference attention.py:134-200, 290-320): q is the center point, k/v
    its K neighbors, p/vp the projected PPF embedding;
    scores = (q.k + q.p)/sqrt(c), out = A @ (v + vp), then linear +
    LayerNorm(residual at the center point)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.attention = _projections(d_model, ("proj_q", "proj_k", "proj_v", "proj_p", "proj_vp"),
                                      dtype)
        self.linear = Linear(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, feats, pos_embed, node_idx, group_idx, neighbor_mask=None):
        """feats (N, d), pos_embed (M, K, d), node_idx (M,) or None (centers
        are all points), group_idx (M, K), neighbor_mask (M, K) -> (M, d)."""
        h = self.num_heads
        c = self.d_model // h
        att = self.attention
        q = att["proj_q"](feats)
        if node_idx is not None:
            q = q[node_idx]
        k = att["proj_k"](feats)[group_idx]  # (M, K, d)
        v = att["proj_v"](feats)[group_idx]
        p = att["proj_p"](pos_embed)
        vp = att["proj_vp"](pos_embed)
        m, kk = group_idx.shape
        prod = (q[:, None, :] * (k + p)).reshape(m, kk, h, c)
        scores = torch.sum(prod, dim=-1) / _scale(c, prod.dtype)  # (M, K, H)
        attn = masked_softmax(scores, None if neighbor_mask is None else neighbor_mask[:, :, None],
                              dim=1)
        w = torch.repeat_interleave(attn, c, dim=-1)  # heads back to channels
        hidden = self.linear(torch.sum(w * (v + vp), dim=1))
        residual = feats if node_idx is None else feats[node_idx]
        return self.norm(hidden + residual)


class LocalPPFTransformer(nn.Module):
    """in_proj -> PPF embed -> local attention -> out_proj
    (reference ppftransformer.py:202-253)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.embedding = PPFEmbedding(hidden_dim, dtype)
        self.in_proj = Linear(input_dim, hidden_dim, dtype)
        self.transformer = LocalPPFAttention(hidden_dim, num_heads, dtype)
        self.out_proj = Linear(hidden_dim, output_dim, dtype)

    def forward(self, feats, node_idx, group_idx, ppf, neighbor_mask=None):
        pos = self.embedding(ppf)
        x = self.in_proj(feats)
        x = self.transformer(x, pos, node_idx, group_idx, neighbor_mask)
        return self.out_proj(x)


class GlobalRPESelfAttention(nn.Module):
    """Self attention over coarse nodes with the geometric embedding as
    relative position, also emitting learned positional states (reference
    RPEMultiHeadAttention, geoattention.py:69-193). The q . b_p score bias is
    constant along the key axis, hence softmax-invariant, and is dropped;
    proj_p.bias stays a parameter so checkpoints load unchanged. More heads
    than the kernels take, or a width the backward does not (supported_heads,
    supported_width), run the plain version, through autograd, as the JAX
    package's XLA path does."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.proj_q = Linear(d_model, d_model, dtype)
        self.proj_k = Linear(d_model, d_model, dtype)
        self.proj_v = Linear(d_model, d_model, dtype)
        self.proj_p = nn.Linear(d_model, d_model)
        self.proj_vp = nn.Linear(d_model, d_model)

    def attend(self, x, embed, key_mask=None):
        """(hidden (..., N, d) fp32, ae (..., N, H, d)): the kernel's two
        outputs, from the q, k, v and p projections."""
        n, d = x.shape[-2:]
        lead = x.shape[:-2]
        h = self.num_heads
        c = d // h
        # the kernels take fp32 q, k, v (cast from the compute dtype)
        q2 = self.proj_q(x).float()
        k2 = self.proj_k(x).float()
        v2 = self.proj_v(x).float()
        wp_h = self.proj_p.weight.t().reshape(d, h, c)  # (D_in, H, c)
        qwp = torch.einsum("...nhc,dhc->...nhd", q2.reshape(*lead, n, h, c), wp_h).contiguous()
        fmask = (torch.ones((*lead, n), dtype=torch.float32, device=x.device)
                 if key_mask is None else key_mask.to(torch.float32))
        kernel = supported_heads(h) and supported_width(d)
        attend = rpe_attention if kernel else rpe_attention_plain
        return attend(q2.contiguous(), k2.contiguous(), v2.contiguous(), qwp,
                      embed.contiguous(), fmask.contiguous())

    def forward(self, x, embed, key_mask=None):
        """x (N, d), embed (N, N, d) (fp32 or bf16), key_mask (N,) ->
        hidden (N, d), pos_states (N, d); or all with a leading pair axis
        (B, ...), one kernel launch for the B pairs. hidden is in x's dtype,
        pos_states in fp32 (the JAX package's bf16 x fp32 promotion)."""
        n, d = x.shape[-2:]
        lead = x.shape[:-2]
        h = self.num_heads
        c = d // h
        hidden, ae = self.attend(x, embed, key_mask)
        wvp_h = self.proj_vp.weight.t().reshape(d, h, c)
        ae = ae.to(x.dtype).float()  # rounded to the compute dtype, as JAX's
        pos = torch.einsum("...nhd,dhc->...nhc", ae, wvp_h) + self.proj_vp.bias.reshape(h, c)
        return hidden.to(x.dtype), pos.reshape(*lead, n, d)


class RPEAttentionLayer(nn.Module):
    """attention -> linear -> LayerNorm(residual); positional states:
    pos_linear -> LayerNorm (reference geoattention.py:196-232)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = GlobalRPESelfAttention(d_model, num_heads, dtype)
        self.linear = Linear(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.pos_linear = Linear(d_model, d_model, dtype)
        self.pos_norm = LayerNorm(d_model, dtype)

    def forward(self, x, embed, key_mask=None):
        hidden, pos = self.attention(x, embed, key_mask)
        out = self.norm(self.linear(hidden) + x)
        return out, self.pos_norm(self.pos_linear(pos))


class RPESelfLayer(nn.Module):
    """RPETransformerLayer (geoattention.py:235-261): RPE attention, then the
    feed-forward block on both the feature and the positional stream."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = RPEAttentionLayer(d_model, num_heads, dtype)
        self.output = AttentionOutput(d_model, dtype)
        self.pos_proj = AttentionOutput(d_model, dtype)

    def forward(self, x, embed, key_mask=None):
        out, pos = self.attention(x, embed, key_mask)
        return self.output(out), self.pos_proj(pos)


class GeoRPEAttention(GlobalRPESelfAttention):
    """GeoTransformer's RPEMultiHeadAttention: the scores and hidden states
    of GlobalRPESelfAttention, on the same kernel, with no positional
    states (no proj_vp); the kernel's second output is dropped."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__(d_model, num_heads, dtype)
        del self.proj_vp

    def forward(self, x, embed, key_mask=None):
        return self.attend(x, embed, key_mask)[0].to(x.dtype)


class GeoRPESelfLayer(nn.Module):
    """GeoTransformer's RPETransformerLayer: RPE attention, linear,
    LayerNorm(residual), then the feed-forward block; no positional
    stream."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = _GeoRPEAttentionLayer(d_model, num_heads, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, embed, key_mask=None):
        return self.output(self.attention(x, embed, key_mask))


class _GeoRPEAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = GeoRPEAttention(d_model, num_heads, dtype)
        self.linear = Linear(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x, embed, key_mask=None):
        return self.norm(self.linear(self.attention(x, embed, key_mask)) + x)


class CrossAttention(nn.Module):
    """Multi-head cross attention whose q/k inputs carry the learned
    positional states (input_q + pos_q, input_k + pos_k), then linear +
    LayerNorm(residual) (reference geoattention.py:10-66)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attention = _projections(d_model, ("proj_q", "proj_k", "proj_v"), dtype)
        self.linear = Linear(d_model, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x, mem, pos_q, pos_k, key_mask=None):
        """x (N, d), mem (M, d), key_mask (M,); or with a leading pair axis."""
        n, d = x.shape[-2:]
        m = mem.shape[-2]
        lead = x.shape[:-2]
        h = self.num_heads
        c = d // h
        in_q = x if pos_q is None else x + pos_q
        in_k = mem if pos_k is None else mem + pos_k
        att = self.attention
        q = att["proj_q"](in_q).reshape(*lead, n, h, c)
        k = att["proj_k"](in_k).reshape(*lead, m, h, c)
        v = att["proj_v"](mem).reshape(*lead, m, h, c)
        scores = torch.einsum("...nhc,...mhc->...hnm", q, k) / _scale(c, q.dtype)
        attn = masked_softmax(scores,
                              None if key_mask is None else key_mask[..., None, None, :])
        hidden = torch.einsum("...hnm,...mhc->...nhc", attn, v).reshape(*lead, n, d)
        return self.norm(self.linear(hidden) + x)


class CrossAttentionLayer(nn.Module):
    """Cross attention + feed-forward block (geoattention.py:264-292)."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = CrossAttention(d_model, num_heads, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, mem, pos_q, pos_k, key_mask=None):
        return self.output(self.attention(x, mem, pos_q, pos_k, key_mask))
