"""Global geometric transformer over coarse nodes.

Counterpart of roitr_tpu/models/transformer.py (reference
model/transformer/geotransformer.py:14-133): interleaved self/cross blocks
where each self block emits learned rotation-invariant positional states
that the following cross block adds to its q/k inputs. One layer instance
serves both clouds (shared weights).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from roitr_torch.models.attention import CrossAttentionLayer, RPESelfLayer
from roitr_torch.models.embeddings import GeometricStructureEmbedding
from roitr_torch.models.layers import Linear

_STORAGE = {"bf16": torch.bfloat16, "fp32": torch.float32}


class _LayerStack(nn.Module):
    """Holds the blocks under the reference's `transformer.layers.<i>` keys."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class GeometricTransformer(nn.Module):
    """embedding -> in_proj -> [self|cross]* -> out_proj
    (reference geotransformer.py:56-133).

    `embedding_storage` is the dtype the (N, N, hidden) geometric embedding
    is stored in: "bf16" (default) halves the bytes the RPE attention
    reads, at one rounding of the stored tensor; "fp32" keeps the
    reference's tensor. `dtype`, the compute dtype of in_proj, the layers
    and out_proj, leaves the embedding alone; both descriptors leave in
    fp32.
    """

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, num_heads: int,
                 blocks: Sequence[str], sigma_d: float = 0.2, sigma_a: float = 15.0,
                 angle_k: int = 3, embedding_storage: str = "bf16", dtype=torch.float32):
        super().__init__()
        if embedding_storage not in _STORAGE:
            raise ValueError(f"embedding_storage must be 'bf16' or 'fp32', got "
                             f"{embedding_storage!r}")
        self.blocks = tuple(blocks)
        self.store = _STORAGE[embedding_storage]
        self.embedding = GeometricStructureEmbedding(hidden_dim, sigma_d, sigma_a, angle_k)
        self.in_proj = Linear(input_dim, hidden_dim, dtype)
        layers = []
        for block in self.blocks:
            if block == "self":
                layers.append(RPESelfLayer(hidden_dim, num_heads, dtype))
            elif block == "cross":
                layers.append(CrossAttentionLayer(hidden_dim, num_heads, dtype))
            else:
                raise ValueError(f"unknown block type {block!r}")
        self.transformer = _LayerStack(layers)
        self.out_proj = Linear(hidden_dim, output_dim, dtype)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_count=None,
                src_count=None, ref_masks=None, src_masks=None):
        ref_embed = self.embedding(ref_points, ref_count, self.store)
        src_embed = self.embedding(src_points, src_count, self.store)
        feats0 = self.in_proj(ref_feats)
        feats1 = self.in_proj(src_feats)
        pos0 = pos1 = None
        for block, layer in zip(self.blocks, self.transformer.layers):
            if block == "self":
                feats0, pos0 = layer(feats0, ref_embed, ref_masks)
                feats1, pos1 = layer(feats1, src_embed, src_masks)
            else:
                # sequential: the second call attends to the updated feats0
                # (reference geotransformer.py:45-46)
                feats0 = layer(feats0, feats1, pos0, pos1, src_masks)
                feats1 = layer(feats1, feats0, pos1, pos0, ref_masks)
        return self.out_proj(feats0).float(), self.out_proj(feats1).float()
