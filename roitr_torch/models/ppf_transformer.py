"""The alternative global transformer conditioned on PPF embeddings.

Counterpart of roitr_tpu/models/ppf_transformer.py (reference
model/transformer/ppftransformer.py:14-199, attention.py:8-131): a
global-mode PPF embedding of each node's neighbourhood, interleaved self
blocks (RPE attention over the embedding) and cross blocks (optionally
adding projected, max-pooled embeddings to q, k and the value). The
default RoITr pipeline does not build it (reference model.py:165 takes the
geometric transformer); the reference ships it as the alternative global
stage. Plain PyTorch in fp32, as the JAX package's version is plain XLA:
no TPU kernel lies on it. The state_dict follows the reference's
`transformer.layers.<i>.attention.attention.*` layout, and
utils/convert.py `ppf_params_to_state_dict` carries JAX weights across.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from roitr_torch.models.attention import AttentionOutput, masked_softmax
from roitr_torch.models.embeddings import PPFEmbedding
from roitr_torch.models.transformer import _LayerStack


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., H * c) -> (..., H, c), head-major (einops '(h c)')."""
    return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)


def _key_mask(key_masks: Optional[torch.Tensor]):
    return None if key_masks is None else key_masks[None, None, :]


class CrossPosEmbedAttention(nn.Module):
    """Multi-head attention; with `with_cross_pos_embed` the projected
    positional embeddings join the scores, (q + pq) . (k + pk), and the
    value, v + vk (reference attention.py:8-74)."""

    def __init__(self, d_model: int, num_heads: int, with_cross_pos_embed: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.with_cross_pos_embed = with_cross_pos_embed
        names = ("proj_q", "proj_k", "proj_v")
        if with_cross_pos_embed:
            names += ("proj_pq", "proj_pk", "proj_vk")
        for name in names:
            setattr(self, name, nn.Linear(d_model, d_model))

    def forward(self, input_q, input_k, input_v, embed_q, embed_k, key_masks=None):
        h = self.num_heads
        q = _heads(self.proj_q(input_q), h)
        k = _heads(self.proj_k(input_k), h)
        v = _heads(self.proj_v(input_v), h)
        if self.with_cross_pos_embed:
            q = q + _heads(self.proj_pq(embed_q), h)
            k = k + _heads(self.proj_pk(embed_k), h)
            v = v + _heads(self.proj_vk(embed_k), h)
        scores = torch.einsum("nhc,mhc->hnm", q, k) / math.sqrt(q.shape[-1])
        attn = masked_softmax(scores, _key_mask(key_masks))
        out = torch.einsum("hnm,mhc->nhc", attn, v)
        return out.reshape(*out.shape[:-2], -1)


class _AttentionLayer(nn.Module):
    """attention -> linear -> LayerNorm(residual) (reference AttentionLayer
    and RPEAttentionLayer)."""

    def __init__(self, attention: nn.Module, d_model: int):
        super().__init__()
        self.attention = attention
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, *args):
        return self.norm(self.linear(self.attention(x, *args)) + x)


class PPFCrossLayer(nn.Module):
    """TransformerLayer of the PPF variant (ppftransformer.py:14-48): the
    neighbourhood embeddings are max-pooled before use."""

    def __init__(self, d_model: int, num_heads: int, with_cross_pos_embed: bool = False):
        super().__init__()
        self.attention = _AttentionLayer(
            CrossPosEmbedAttention(d_model, num_heads, with_cross_pos_embed), d_model)
        self.output = AttentionOutput(d_model)

    def forward(self, x, mem, embed_q, embed_k, key_masks=None):
        eq = None if embed_q is None else torch.amax(embed_q, dim=-2)
        ek = None if embed_k is None else torch.amax(embed_k, dim=-2)
        return self.output(self.attention(x, mem, mem, eq, ek, key_masks))


class PPFRPEAttention(nn.Module):
    """Relative-position attention over the all-pairs PPF embedding e
    (N, N, d) (reference RPEMultiHeadAttention, attention.py:77-131):
    scores = (q . k + q . proj_p(e)) / sqrt(c), out = A v + sum_m A
    proj_vp(e), with the projections factored as the JAX package does
    ((q W_p) . e + q . b_p and proj_vp(sum_m A e)), never building the
    per-head (N, N, c) tensors."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for name in ("proj_q", "proj_k", "proj_v", "proj_p", "proj_vp"):
            setattr(self, name, nn.Linear(d_model, d_model))

    def forward(self, x, embed, key_masks=None):
        h = self.num_heads
        d = x.shape[-1]
        c = d // h
        q = _heads(self.proj_q(x), h)
        k = _heads(self.proj_k(x), h)
        v = _heads(self.proj_v(x), h)
        qwp = torch.einsum("nhc,dhc->nhd", q, self.proj_p.weight.t().reshape(d, h, c))
        scores_p = torch.einsum("nhd,nmd->hnm", qwp, embed)
        scores_p = scores_p + torch.einsum("nhc,hc->hn", q,
                                           self.proj_p.bias.reshape(h, c))[:, :, None]
        scores = (torch.einsum("nhc,mhc->hnm", q, k) + scores_p) / math.sqrt(c)
        attn = masked_softmax(scores, _key_mask(key_masks))
        hidden = torch.einsum("hnm,mhc->nhc", attn, v)
        ae = torch.einsum("hnm,nmd->nhd", attn, embed)
        hidden = hidden + torch.einsum("nhd,dhc->nhc", ae,
                                       self.proj_vp.weight.t().reshape(d, h, c))
        hidden = hidden + self.proj_vp.bias.reshape(h, c)
        return hidden.reshape(*hidden.shape[:-2], d)


class PPFSelfLayer(nn.Module):
    """RPETransformerLayer of the PPF variant (ppftransformer.py:51-75)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attention = _AttentionLayer(PPFRPEAttention(d_model, num_heads), d_model)
        self.output = AttentionOutput(d_model)

    def forward(self, x, embed, key_masks=None):
        return self.output(self.attention(x, embed, key_masks))


class PPFTransformer(nn.Module):
    """embedding -> in_proj -> [self|cross]* -> out_proj (reference
    ppftransformer.py:125-199). One layer instance serves both clouds."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 blocks: Sequence[str], with_cross_pos_embed: bool = False):
        super().__init__()
        self.blocks = tuple(blocks)
        self.embedding = PPFEmbedding(hidden_dim, mode="global")
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        layers = []
        for block in self.blocks:
            if block == "self":
                layers.append(PPFSelfLayer(hidden_dim, num_heads))
            elif block == "cross":
                layers.append(PPFCrossLayer(hidden_dim, num_heads, with_cross_pos_embed))
            else:
                raise ValueError(f"unknown block type {block!r}")
        self.transformer = _LayerStack(layers)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_feats: torch.Tensor, src_feats: torch.Tensor, ref_ppfs: torch.Tensor,
                src_ppfs: torch.Tensor, ref_masks: Optional[torch.Tensor] = None,
                src_masks: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (N, C) / (M, C), ppfs (N, N, 4) / (M, M, 4), masks (N,) /
        (M,) True = valid -> (N, output_dim), (M, output_dim)."""
        ref_embed = self.embedding(ref_ppfs)
        src_embed = self.embedding(src_ppfs)
        feats0, feats1 = self.in_proj(ref_feats), self.in_proj(src_feats)
        for block, layer in zip(self.blocks, self.transformer.layers):
            if block == "self":
                feats0 = layer(feats0, ref_embed, ref_masks)
                feats1 = layer(feats1, src_embed, src_masks)
            else:
                feats0 = layer(feats0, feats1, ref_embed, src_embed, src_masks)
                feats1 = layer(feats1, feats0, src_embed, ref_embed, ref_masks)
        return self.out_proj(feats0), self.out_proj(feats1)
