"""Rotation-invariant point transformer backbone (encoder-decoder).

Counterpart of roitr_tpu/models/backbone.py (reference model/model.py:13-237)
on padded prefix-packed clouds: a 4-level U-Net whose every level attends
over kNN neighborhoods with PPF relative geometry, a global geometric
transformer at the coarsest level, and an interpolating decoder. Without
a pyramid, FPS and kNN run on the device: the FPS pyramid of both clouds in
one kernel launch per level, the kNN as tiled exact search. With a pyramid
(data/pyramid.py on the host, ops/pyramid.py on the device) the encoder
takes its FPS, cross and self kNN indices from it and the decoder its 3-NN
indices and weights, and no search runs here. Per-level self-kNN indices
and PPFs are computed once and shared by every block of the level.

Packed batches (data/packing.py, counts of shape (B,)): every point array
is B aligned per-pair segments concatenated flat, and the pyramid's
indices are offset per segment, so the point levels run unchanged on the
flat arrays; the global transformer runs on free (B, m4, ...) views. A
packed pair needs its pyramids: the searches here are per cloud.

`dtype` is the compute dtype of every layer (models/layers.py); points,
normals, PPFs and the pooled mean's sum stay fp32, as in the JAX package,
and where it adds a bf16 tensor to an fp32 one (the decoder's
interpolation and residuals) the sum is fp32 here too. `remat` recomputes
each local PPF transformer in the backward instead of keeping its
activations (torch.utils.checkpoint, JAX's nn.remat): the same modules
JAX wraps, and nothing else, so no search runs twice.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from roitr_torch.models.attention import LocalPPFTransformer
from roitr_torch.models.layers import LayerNorm, Linear
from roitr_torch.models.transformer import GeometricTransformer
from roitr_torch.ops.fps import furthest_point_sampling, num_valid_samples
from roitr_torch.ops.geometry import calc_ppf, index_valid, prefix_mask
from roitr_torch.ops.neighbors import masked_knn, three_nn_interpolate
from roitr_torch.utils.profiling import span


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


def _local(transformer: LocalPPFTransformer, remat: bool, *args):
    """A local PPF transformer's call, recomputed in the backward when
    `remat` (and a graph is being built)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(transformer, *args, use_reentrant=False)
    return transformer(*args)


def _is_packed(count) -> bool:
    """Packed-batch mode: count is a (B,) vector (data/packing.py)."""
    return count.ndim == 1


def _self_neighborhood(points, normals, count, nsample, self_idx=None):
    """Self-kNN (excluding the point itself) + PPFs for one level."""
    if self_idx is not None:
        group_idx = self_idx
    elif _is_packed(count):
        raise ValueError("packed batches require host-precomputed kNN indices")
    else:
        group_idx, _ = masked_knn(points, points, count, nsample, exclude_self=True)
    neighbor_mask = index_valid(group_idx, count, points.shape[0])
    ppf = calc_ppf(points, normals, points[group_idx], normals[group_idx])
    return group_idx, ppf, neighbor_mask


class TransitionDown(nn.Module):
    """FPS downsample + cross-kNN PPF attention pooling into the sampled set
    (reference model.py:47-80)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, num_heads: int,
                 stride: int, nsample: int, dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.stride = stride
        self.nsample = nsample
        self.remat = remat
        self.transformer = LocalPPFTransformer(in_dim, hidden_dim, out_dim, num_heads, dtype)

    def forward(self, points, normals, feats, count, fps_idx=None, cross_idx=None):
        n = points.shape[0]
        if self.stride != 1:
            idx = fps_idx
            if idx is None:
                if _is_packed(count):
                    raise ValueError("packed batches require host-precomputed FPS indices")
                idx = furthest_point_sampling(points[None], count.reshape(1),
                                              n // self.stride)[0]
            new_count = num_valid_samples(count, self.stride)
            new_points, new_normals = points[idx], normals[idx]
        else:
            idx = None
            new_count = count
            new_points, new_normals = points, normals
        if cross_idx is not None:
            group_idx = cross_idx
        elif _is_packed(count):
            raise ValueError("packed batches require host-precomputed kNN indices")
        else:
            group_idx, _ = masked_knn(new_points, points, count, self.nsample,
                                      exclude_self=True)
        neighbor_mask = index_valid(group_idx, count, n)
        ppf = calc_ppf(new_points, new_normals, points[group_idx], normals[group_idx])
        x = _local(self.transformer, self.remat, feats, idx, group_idx, ppf, neighbor_mask)
        return new_points, new_normals, x, new_count, idx


class PointTransformerLayer(nn.Module):
    """Holds a block's LocalPPFTransformer under the reference's
    `transformer.transformer` keys (reference model.py RIPointTransformerLayer)."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.transformer = LocalPPFTransformer(dim, hidden_dim, dim, num_heads, dtype)

    def forward(self, feats, group_idx, ppf, neighbor_mask):
        return _local(self.transformer, self.remat, feats, None, group_idx, ppf, neighbor_mask)


class PointBlock(nn.Module):
    """Local PPF attention + LayerNorm + residual + ReLU over a fixed level
    (reference model.py:120-142)."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.transformer = PointTransformerLayer(dim, hidden_dim, num_heads, dtype, remat)
        self.bn2 = LayerNorm(dim, dtype)

    def forward(self, feats, group_idx, ppf, neighbor_mask):
        x = self.bn2(self.transformer(feats, group_idx, ppf, neighbor_mask))
        return F.relu(x + feats)


class TransitionUpHead(nn.Module):
    """Coarsest-level decoder head: concat of the mean-pooled global feature
    (reference model.py:99-112, is_head branch)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.linear1 = nn.Sequential(Linear(2 * dim, dim, dtype), LayerNorm(dim, dtype),
                                     nn.ReLU())
        self.linear2 = nn.Sequential(Linear(dim, dim, dtype), nn.ReLU())

    def forward(self, feats, count):
        mask = prefix_mask(feats.shape[0], count, device=feats.device)[:, None]
        # the mean in fp32, cast back to the features' dtype
        masked = torch.where(mask, feats, torch.zeros_like(feats)).float()
        denom = torch.clamp(count, min=1).to(torch.float32)
        if _is_packed(count):  # per-pair pooling over the aligned segments
            b = count.shape[0]
            seg = feats.shape[0] // b
            pooled = (masked.reshape(b, seg, -1).sum(dim=1) / denom[:, None]).to(feats.dtype)
            g = torch.repeat_interleave(self.linear2(pooled), seg, dim=0)
        else:
            pooled = (masked.sum(dim=0, keepdim=True) / denom).to(feats.dtype)
            g = self.linear2(pooled).expand(feats.shape[0], -1)
        return self.linear1(torch.cat([feats, g], dim=-1))


class TransitionUp(nn.Module):
    """Decoder upsample: lateral projection + 3-NN inverse-distance
    interpolation of the coarser level (reference model.py:113-117)."""

    def __init__(self, coarse_dim: int, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear1 = nn.Sequential(Linear(out_dim, out_dim, dtype), LayerNorm(out_dim, dtype),
                                     nn.ReLU())
        self.linear2 = nn.Sequential(Linear(coarse_dim, out_dim, dtype),
                                     LayerNorm(out_dim, dtype), nn.ReLU())

    def forward(self, points, feats, coarse_points, coarse_feats, coarse_count, up_idx=None,
                up_w=None):
        up = three_nn_interpolate(points, coarse_points, self.linear2(coarse_feats), coarse_count,
                                  idx=up_idx, weight=up_w)
        return self.linear1(feats) + up


class RIPointTransformer(nn.Module):
    """The full backbone (reference model.py:145-237)."""

    def __init__(self, transformer_blocks: Sequence[str], factor: int = 1, num_heads: int = 4,
                 enc_blocks: Sequence[int] = (2, 3, 3, 3), strides: Sequence[int] = (1, 4, 4, 4),
                 nsample: Sequence[int] = (8, 16, 16, 16), geo_embedding_storage: str = "bf16",
                 dtype=torch.float32, remat_local: bool = False):
        super().__init__()
        f = factor
        planes = [64 * f, 128 * f, 256 * f, 256 * f]
        self.strides = tuple(strides)
        self.nsample = tuple(nsample)
        in_dim = 1
        for lvl in range(4):
            p = planes[lvl]
            hid = min(p, 256 * f)
            stage = [TransitionDown(in_dim, p, hid, num_heads, strides[lvl], nsample[lvl], dtype,
                                    remat_local)]
            stage += [PointBlock(p, hid, num_heads, dtype, remat_local)
                      for _ in range(1, enc_blocks[lvl])]
            setattr(self, f"enc{lvl + 1}", nn.ModuleList(stage))
            in_dim = p
        self.global_transformer = GeometricTransformer(
            planes[3], planes[3], planes[3], num_heads, transformer_blocks, sigma_d=0.2,
            sigma_a=15.0, angle_k=3, embedding_storage=geo_embedding_storage, dtype=dtype)
        self.dec4 = nn.ModuleList([
            TransitionUpHead(planes[3], dtype),
            PointBlock(planes[3], min(planes[3], 256 * f), num_heads, dtype, remat_local)])
        for lvl in (3, 2, 1):
            p = planes[lvl - 1]
            setattr(self, f"dec{lvl}", nn.ModuleList([
                TransitionUp(planes[lvl], p, dtype),
                PointBlock(p, min(p, 256 * f), num_heads, dtype, remat_local)]))

    def encode(self, points, normals, feats, count, fps_idx: List, pyramid=None) -> List[Level]:
        """`fps_idx`: per level, device FPS indices or None; a `pyramid`
        (CloudPyramid of tensors) supplies every level's indices instead."""
        levels = []
        p, nrm, x, cnt = points, normals, feats, count
        for lvl in range(4):
            stage = getattr(self, f"enc{lvl + 1}")
            fps, cross, self_idx = fps_idx[lvl], None, None
            if pyramid is not None:
                fps = getattr(pyramid, f"fps_idx{lvl + 1}") if lvl > 0 else None
                cross = getattr(pyramid, f"cross_idx{lvl + 1}")
                self_idx = getattr(pyramid, f"self_idx{lvl + 1}")
            p, nrm, x, cnt, down_idx = stage[0](p, nrm, x, cnt, fps_idx=fps, cross_idx=cross)
            group_idx, ppf, nmask = _self_neighborhood(p, nrm, cnt, self.nsample[lvl], self_idx)
            for block in stage[1:]:
                x = block(x, group_idx, ppf, nmask)
            levels.append(Level(p, nrm, x, cnt, group_idx, ppf, nmask, down_idx))
        return levels

    def decode(self, levels: List[Level], pyramid=None) -> torch.Tensor:
        l1, l2, l3, l4 = levels
        up = lambda n: (None, None) if pyramid is None else (
            getattr(pyramid, f"up_idx{n}"), getattr(pyramid, f"up_w{n}"))
        x4 = self.dec4[1](self.dec4[0](l4.feats, l4.count), l4.group_idx, l4.ppf, l4.neighbor_mask)
        x3 = self.dec3[1](self.dec3[0](l3.points, l3.feats, l4.points, x4, l4.count, *up(4)),
                          l3.group_idx, l3.ppf, l3.neighbor_mask)
        x2 = self.dec2[1](self.dec2[0](l2.points, l2.feats, l3.points, x3, l3.count, *up(3)),
                          l2.group_idx, l2.ppf, l2.neighbor_mask)
        x1 = self.dec1[1](self.dec1[0](l1.points, l1.feats, l2.points, x2, l2.count, *up(2)),
                          l1.group_idx, l1.ppf, l1.neighbor_mask)
        return x1

    def forward(self, src_points, src_normals, src_feats, src_count, tgt_points, tgt_normals,
                tgt_feats, tgt_count, src_deformed, src_pyramid=None, tgt_pyramid=None):
        """Both clouds of a pair; counts are 0-dim int64 tensors, or (B,)
        for a packed batch. Returns (src_nodes, src_node_feats, src_points,
        src_point_feats, src_node_count, tgt_nodes, tgt_node_feats,
        tgt_points, tgt_point_feats, tgt_node_count) like the JAX backbone."""
        packed = _is_packed(src_count)
        dev = src_points.device
        with span("model.local", dev):
            s_fps = t_fps = [None] * 4
            if (not packed and src_pyramid is None and tgt_pyramid is None
                    and src_points.shape == tgt_points.shape):
                s_fps, t_fps = _device_fps_pyramids(src_points, src_count, tgt_points, tgt_count,
                                                    self.strides)
            s_levels = self.encode(src_points, src_normals, src_feats, src_count, s_fps,
                                   src_pyramid)
            t_levels = self.encode(tgt_points, tgt_normals, tgt_feats, tgt_count, t_fps,
                                   tgt_pyramid)
        s4, t4 = s_levels[3], t_levels[3]
        with span("model.transformer", dev):
            s_mask4 = prefix_mask(s4.points.shape[0], s4.count, device=dev)
            t_mask4 = prefix_mask(t4.points.shape[0], t4.count, device=dev)
            if packed:
                # per-pair coarse transformer on free (B, m4, ...) views of the
                # aligned segments: one embedding launch and one RPE attention
                # launch a layer cover all B pairs
                b = src_count.shape[0]
                view = lambda a: a.reshape(b, a.shape[0] // b, *a.shape[1:])
                s_gx4, t_gx4 = self.global_transformer(
                    view(s4.points), view(t4.points), view(s4.feats), view(t4.feats),
                    ref_count=s4.count, src_count=t4.count, ref_masks=view(s_mask4),
                    src_masks=view(t_mask4))
                s_gx4, t_gx4 = s_gx4.flatten(0, 1), t_gx4.flatten(0, 1)
            else:
                s_gx4, t_gx4 = self.global_transformer(
                    s4.points, t4.points, s4.feats, t4.feats, ref_count=s4.count,
                    src_count=t4.count, ref_masks=s_mask4, src_masks=t_mask4)
        with span("model.local", dev):
            s_x1 = self.decode(s_levels, src_pyramid)
            t_x1 = self.decode(t_levels, tgt_pyramid)
            # chain FPS indices back to raw ordering (reference model.py:233-235)
            idx4_in_1 = s_levels[1].down_idx[s_levels[2].down_idx][s_levels[3].down_idx]
            s_nodes = src_deformed[idx4_in_1]
        return (s_nodes, s_gx4, src_deformed, s_x1, s4.count, t4.points, t_gx4,
                t_levels[0].points, t_x1, t4.count)
