"""Rotation-invariant point transformer backbone (encoder-decoder).

Counterpart of roitr_tpu/models/backbone.py (reference model/model.py:13-237)
on padded prefix-packed clouds: a 4-level U-Net whose every level attends
over kNN neighborhoods with PPF relative geometry, a global geometric
transformer at the coarsest level, and an interpolating decoder. FPS and
kNN run on the device: the FPS pyramid of both clouds in one kernel launch
per level, the kNN as tiled exact search. Per-level self-kNN indices and
PPFs are computed once and shared by every block of the level.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from roitr_torch.models.attention import LocalPPFTransformer
from roitr_torch.models.transformer import GeometricTransformer
from roitr_torch.ops.fps import furthest_point_sampling, num_valid_samples
from roitr_torch.ops.geometry import calc_ppf, index_valid, prefix_mask
from roitr_torch.ops.neighbors import masked_knn, three_nn_interpolate


class Level(NamedTuple):
    """One resolution level of a cloud (fixed shapes, prefix-packed)."""

    points: torch.Tensor  # (M, 3)
    normals: torch.Tensor  # (M, 3)
    feats: torch.Tensor  # (M, C)
    count: torch.Tensor  # () valid prefix length
    group_idx: torch.Tensor  # (M, K) self-kNN (excluding self)
    ppf: torch.Tensor  # (M, K, 4)
    neighbor_mask: torch.Tensor  # (M, K)
    down_idx: Optional[torch.Tensor]  # (M,) index into the parent level


def _device_fps_pyramids(src_points, src_count, tgt_points, tgt_count, strides):
    """FPS indices of every downsampling level for both clouds, sampled
    together (one launch per level). Returns two lists indexed by level,
    None where the stride is 1."""
    pts = torch.stack([src_points, tgt_points])
    cnt = torch.stack([src_count, tgt_count])
    fps = ([], [])
    for stride in strides:
        if stride == 1:
            fps[0].append(None)
            fps[1].append(None)
            continue
        idx = furthest_point_sampling(pts, cnt, pts.shape[1] // stride)
        fps[0].append(idx[0])
        fps[1].append(idx[1])
        pts = torch.gather(pts, 1, idx[:, :, None].expand(-1, -1, 3))
        cnt = num_valid_samples(cnt, stride)
    return fps


def _self_neighborhood(points, normals, count, nsample):
    """Self-kNN (excluding the point itself) + PPFs for one level."""
    group_idx, _ = masked_knn(points, points, count, nsample, exclude_self=True)
    neighbor_mask = index_valid(group_idx, count)
    ppf = calc_ppf(points, normals, points[group_idx], normals[group_idx])
    return group_idx, ppf, neighbor_mask


class TransitionDown(nn.Module):
    """FPS downsample + cross-kNN PPF attention pooling into the sampled set
    (reference model.py:47-80)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, num_heads: int,
                 stride: int, nsample: int):
        super().__init__()
        self.stride = stride
        self.nsample = nsample
        self.transformer = LocalPPFTransformer(in_dim, hidden_dim, out_dim, num_heads)

    def forward(self, points, normals, feats, count, fps_idx=None):
        n = points.shape[0]
        if self.stride != 1:
            idx = fps_idx
            if idx is None:
                idx = furthest_point_sampling(points[None], count.reshape(1),
                                              n // self.stride)[0]
            new_count = num_valid_samples(count, self.stride)
            new_points, new_normals = points[idx], normals[idx]
        else:
            idx = None
            new_count = count
            new_points, new_normals = points, normals
        group_idx, _ = masked_knn(new_points, points, count, self.nsample, exclude_self=True)
        neighbor_mask = index_valid(group_idx, count)
        ppf = calc_ppf(new_points, new_normals, points[group_idx], normals[group_idx])
        x = self.transformer(feats, idx, group_idx, ppf, neighbor_mask)
        return new_points, new_normals, x, new_count, idx


class PointTransformerLayer(nn.Module):
    """Holds a block's LocalPPFTransformer under the reference's
    `transformer.transformer` keys (reference model.py RIPointTransformerLayer)."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.transformer = LocalPPFTransformer(dim, hidden_dim, dim, num_heads)

    def forward(self, feats, group_idx, ppf, neighbor_mask):
        return self.transformer(feats, None, group_idx, ppf, neighbor_mask)


class PointBlock(nn.Module):
    """Local PPF attention + LayerNorm + residual + ReLU over a fixed level
    (reference model.py:120-142)."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int):
        super().__init__()
        self.transformer = PointTransformerLayer(dim, hidden_dim, num_heads)
        self.bn2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, feats, group_idx, ppf, neighbor_mask):
        x = self.bn2(self.transformer(feats, group_idx, ppf, neighbor_mask))
        return F.relu(x + feats)


class TransitionUpHead(nn.Module):
    """Coarsest-level decoder head: concat of the mean-pooled global feature
    (reference model.py:99-112, is_head branch)."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(2 * dim, dim), nn.LayerNorm(dim, eps=1e-5),
                                     nn.ReLU())
        self.linear2 = nn.Sequential(nn.Linear(dim, dim), nn.ReLU())

    def forward(self, feats, count):
        mask = prefix_mask(feats.shape[0], count, device=feats.device)[:, None]
        masked = torch.where(mask, feats, torch.zeros_like(feats))
        denom = torch.clamp(count, min=1).to(torch.float32)
        pooled = masked.sum(dim=0, keepdim=True) / denom
        g = self.linear2(pooled).expand(feats.shape[0], -1)
        return self.linear1(torch.cat([feats, g], dim=-1))


class TransitionUp(nn.Module):
    """Decoder upsample: lateral projection + 3-NN inverse-distance
    interpolation of the coarser level (reference model.py:113-117)."""

    def __init__(self, coarse_dim: int, out_dim: int):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(out_dim, out_dim), nn.LayerNorm(out_dim, eps=1e-5),
                                     nn.ReLU())
        self.linear2 = nn.Sequential(nn.Linear(coarse_dim, out_dim),
                                     nn.LayerNorm(out_dim, eps=1e-5), nn.ReLU())

    def forward(self, points, feats, coarse_points, coarse_feats, coarse_count):
        up = three_nn_interpolate(points, coarse_points, self.linear2(coarse_feats), coarse_count)
        return self.linear1(feats) + up


class RIPointTransformer(nn.Module):
    """The full backbone (reference model.py:145-237)."""

    def __init__(self, transformer_blocks: Sequence[str], factor: int = 1, num_heads: int = 4,
                 enc_blocks: Sequence[int] = (2, 3, 3, 3), strides: Sequence[int] = (1, 4, 4, 4),
                 nsample: Sequence[int] = (8, 16, 16, 16), geo_embedding_storage: str = "bf16"):
        super().__init__()
        f = factor
        planes = [64 * f, 128 * f, 256 * f, 256 * f]
        self.strides = tuple(strides)
        self.nsample = tuple(nsample)
        in_dim = 1
        for lvl in range(4):
            p = planes[lvl]
            hid = min(p, 256 * f)
            stage = [TransitionDown(in_dim, p, hid, num_heads, strides[lvl], nsample[lvl])]
            stage += [PointBlock(p, hid, num_heads) for _ in range(1, enc_blocks[lvl])]
            setattr(self, f"enc{lvl + 1}", nn.ModuleList(stage))
            in_dim = p
        self.global_transformer = GeometricTransformer(
            planes[3], planes[3], planes[3], num_heads, transformer_blocks, sigma_d=0.2,
            sigma_a=15.0, angle_k=3, embedding_storage=geo_embedding_storage)
        self.dec4 = nn.ModuleList([TransitionUpHead(planes[3]),
                                   PointBlock(planes[3], min(planes[3], 256 * f), num_heads)])
        for lvl in (3, 2, 1):
            p = planes[lvl - 1]
            setattr(self, f"dec{lvl}", nn.ModuleList([
                TransitionUp(planes[lvl], p), PointBlock(p, min(p, 256 * f), num_heads)]))

    def encode(self, points, normals, feats, count, fps_idx: List) -> List[Level]:
        levels = []
        p, nrm, x, cnt = points, normals, feats, count
        for lvl in range(4):
            stage = getattr(self, f"enc{lvl + 1}")
            p, nrm, x, cnt, down_idx = stage[0](p, nrm, x, cnt, fps_idx=fps_idx[lvl])
            group_idx, ppf, nmask = _self_neighborhood(p, nrm, cnt, self.nsample[lvl])
            for block in stage[1:]:
                x = block(x, group_idx, ppf, nmask)
            levels.append(Level(p, nrm, x, cnt, group_idx, ppf, nmask, down_idx))
        return levels

    def decode(self, levels: List[Level]) -> torch.Tensor:
        l1, l2, l3, l4 = levels
        x4 = self.dec4[1](self.dec4[0](l4.feats, l4.count), l4.group_idx, l4.ppf, l4.neighbor_mask)
        x3 = self.dec3[1](self.dec3[0](l3.points, l3.feats, l4.points, x4, l4.count),
                          l3.group_idx, l3.ppf, l3.neighbor_mask)
        x2 = self.dec2[1](self.dec2[0](l2.points, l2.feats, l3.points, x3, l3.count),
                          l2.group_idx, l2.ppf, l2.neighbor_mask)
        x1 = self.dec1[1](self.dec1[0](l1.points, l1.feats, l2.points, x2, l2.count),
                          l1.group_idx, l1.ppf, l1.neighbor_mask)
        return x1

    def forward(self, src_points, src_normals, src_feats, src_count, tgt_points, tgt_normals,
                tgt_feats, tgt_count, src_deformed):
        """Both clouds of a pair; counts are 0-dim int64 tensors. Returns
        (src_nodes, src_node_feats, src_points, src_point_feats,
        src_node_count, tgt_nodes, tgt_node_feats, tgt_points,
        tgt_point_feats, tgt_node_count) like the JAX backbone."""
        if src_points.shape == tgt_points.shape:
            s_fps, t_fps = _device_fps_pyramids(src_points, src_count, tgt_points, tgt_count,
                                                self.strides)
        else:
            s_fps = t_fps = [None] * 4
        s_levels = self.encode(src_points, src_normals, src_feats, src_count, s_fps)
        t_levels = self.encode(tgt_points, tgt_normals, tgt_feats, tgt_count, t_fps)
        s4, t4 = s_levels[3], t_levels[3]
        s_mask4 = prefix_mask(s4.points.shape[0], s4.count, device=s4.points.device)
        t_mask4 = prefix_mask(t4.points.shape[0], t4.count, device=t4.points.device)
        s_gx4, t_gx4 = self.global_transformer(
            s4.points, t4.points, s4.feats, t4.feats, ref_count=s4.count, src_count=t4.count,
            ref_masks=s_mask4, src_masks=t_mask4)
        s_x1 = self.decode(s_levels)
        t_x1 = self.decode(t_levels)
        # chain FPS indices back to raw ordering (reference model.py:233-235)
        idx4_in_1 = s_levels[1].down_idx[s_levels[2].down_idx][s_levels[3].down_idx]
        s_nodes = src_deformed[idx4_in_1]
        return (s_nodes, s_gx4, src_deformed, s_x1, s4.count, t4.points, t_gx4,
                t_levels[0].points, t_x1, t4.count)
