"""RoITr's network in plain PyTorch, fp32, one pair, every search on the
device inside the forward.

The backbone (RoITr model/model.py:13-237): a four-level encoder of local
point-pair-feature attention over kNN neighbourhoods with FPS between
levels, the global geometric transformer (model/transformer/
geotransformer.py, positional_encoding.py, geoattention.py) over the
coarsest nodes, and an interpolating decoder; then the descriptor
projections, the point-to-node partition, coarse matching (or, in
training, sampled ground-truth patches), Sinkhorn OT and fine matching
(RIGA_v2.py:10-180), and the losses (lib/loss.py). The geometric
embedding and the RPE attention are written as their equations: the
sinusoidal basis times both projections with the max over the angle
neighbours, and the two softmaxes over (q.k + (q W_p).e) / sqrt(c). Module
names follow the RoITr checkpoint's keys, so one state_dict serves both
sides. This file imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops


def masked_softmax(scores, mask, dim: int = -1):
    """Softmax along `dim`, `mask` True = keep; all-masked rows give zeros."""
    if mask is not None:
        scores = torch.where(mask, scores, -math.inf)
    m = torch.amax(scores, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m)
    if mask is not None:
        e = torch.where(mask, e, torch.zeros_like(e))
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.where(s == 0.0, torch.ones_like(s), s)


def sinusoidal_basis(x, hidden: int):
    """x (*,) -> (*, hidden): [sin0, cos0, sin1, cos1, ...] with frequencies
    exp(-2i log(1e4) / hidden) (positional_encoding.py:38-62)."""
    div = torch.exp(torch.arange(0, hidden, 2, dtype=torch.float32, device=x.device)
                    * (-math.log(10000.0) / hidden))
    om = x[..., None] * div
    return torch.stack([torch.sin(om), torch.cos(om)], dim=-1).reshape(x.shape + (hidden,))


class AttentionOutput(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.expand = nn.Linear(d, 2 * d)
        self.squeeze = nn.Linear(2 * d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class PPFEmbedding(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.proj = nn.Linear(4, hidden)

    def forward(self, ppf):
        return self.proj(ppf)


class LocalPPFAttention(nn.Module):
    """scores = (q.k + q.p) / sqrt(c) over a point's K neighbours,
    out = A (v + vp), linear, LayerNorm with the centre's residual."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.d, self.heads = d, heads
        self.attention = nn.ModuleDict({n: nn.Linear(d, d) for n in
                                        ("proj_q", "proj_k", "proj_v", "proj_p", "proj_vp")})
        self.linear = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, feats, pos, node_idx, group_idx, neighbor_mask):
        h = self.heads
        c = self.d // h
        att = self.attention
        q = att["proj_q"](feats)
        if node_idx is not None:
            q = q[node_idx]
        k = att["proj_k"](feats)[group_idx]
        v = att["proj_v"](feats)[group_idx]
        p = att["proj_p"](pos)
        vp = att["proj_vp"](pos)
        m, kk = group_idx.shape
        prod = (q[:, None, :] * (k + p)).reshape(m, kk, h, c)
        scores = torch.sum(prod, dim=-1) / torch.tensor(math.sqrt(c), dtype=prod.dtype).item()
        attn = masked_softmax(scores, neighbor_mask[:, :, None], dim=1)
        w = torch.repeat_interleave(attn, c, dim=-1)
        hidden = self.linear(torch.sum(w * (v + vp), dim=1))
        residual = feats if node_idx is None else feats[node_idx]
        return self.norm(hidden + residual)


class LocalPPFTransformer(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, heads: int):
        super().__init__()
        self.embedding = PPFEmbedding(hidden)
        self.in_proj = nn.Linear(din, hidden)
        self.transformer = LocalPPFAttention(hidden, heads)
        self.out_proj = nn.Linear(hidden, dout)

    def forward(self, feats, node_idx, group_idx, ppf, neighbor_mask):
        return self.out_proj(self.transformer(self.in_proj(feats), self.embedding(ppf), node_idx,
                                              group_idx, neighbor_mask))


class TransitionDown(nn.Module):
    def __init__(self, din, dout, hidden, heads, stride, nsample):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.transformer = LocalPPFTransformer(din, hidden, dout, heads)

    def forward(self, points, normals, feats, count, fps_idx):
        if self.stride != 1:
            idx = fps_idx
            new_count = ops.num_valid_samples(count, self.stride)
            new_points, new_normals = points[idx], normals[idx]
        else:
            idx, new_count, new_points, new_normals = None, count, points, normals
        group_idx, _ = ops.masked_knn(new_points, points, count, self.nsample, exclude_self=True)
        mask = group_idx < count
        ppf = ops.calc_ppf(new_points, new_normals, points[group_idx], normals[group_idx])
        x = self.transformer(feats, idx, group_idx, ppf, mask)
        return new_points, new_normals, x, new_count, idx


class PointTransformerLayer(nn.Module):
    def __init__(self, d, hidden, heads):
        super().__init__()
        self.transformer = LocalPPFTransformer(d, hidden, d, heads)

    def forward(self, feats, group_idx, ppf, mask):
        return self.transformer(feats, None, group_idx, ppf, mask)


class PointBlock(nn.Module):
    def __init__(self, d, hidden, heads):
        super().__init__()
        self.transformer = PointTransformerLayer(d, hidden, heads)
        self.bn2 = nn.LayerNorm(d)

    def forward(self, feats, group_idx, ppf, mask):
        return F.relu(self.bn2(self.transformer(feats, group_idx, ppf, mask)) + feats)


class TransitionUpHead(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(2 * d, d), nn.LayerNorm(d), nn.ReLU())
        self.linear2 = nn.Sequential(nn.Linear(d, d), nn.ReLU())

    def forward(self, feats, count):
        mask = ops.prefix_mask(feats.shape[0], count, device=feats.device)[:, None]
        masked = torch.where(mask, feats, torch.zeros_like(feats))
        pooled = masked.sum(dim=0, keepdim=True) / torch.clamp(count, min=1).to(torch.float32)
        g = self.linear2(pooled).expand(feats.shape[0], -1)
        return self.linear1(torch.cat([feats, g], dim=-1))


class TransitionUp(nn.Module):
    def __init__(self, dcoarse, dout):
        super().__init__()
        self.linear1 = nn.Sequential(nn.Linear(dout, dout), nn.LayerNorm(dout), nn.ReLU())
        self.linear2 = nn.Sequential(nn.Linear(dcoarse, dout), nn.LayerNorm(dout), nn.ReLU())

    def forward(self, points, feats, coarse_points, coarse_feats, coarse_count):
        up = ops.three_nn_interpolate(points, coarse_points, self.linear2(coarse_feats),
                                      coarse_count)
        return self.linear1(feats) + up


class GeometricStructureEmbedding(nn.Module):
    """Distance and triplet-angle sinusoidal embeddings of the node pairs,
    projected, the angle term maxed over the k nearest nodes."""

    def __init__(self, hidden, sigma_d=0.2, sigma_a=15.0, angle_k=3):
        super().__init__()
        self.hidden, self.sigma_d, self.sigma_a, self.angle_k = hidden, sigma_d, sigma_a, angle_k
        self.proj_d = nn.Linear(hidden, hidden)
        self.proj_a = nn.Linear(hidden, hidden)

    def forward(self, points, count):
        n = points.shape[0]
        dev = points.device
        mask = torch.arange(n, device=dev) < torch.as_tensor(count, device=dev)
        with torch.no_grad():
            sq = ops.masked_pairwise_sq_dist(points, points, y_mask=mask, fill=ops.INF)
            d_idx = torch.sqrt(ops.pairwise_sq_dist(points, points)) / self.sigma_d
            k = max(min(self.angle_k, n - 1), 1)
            near, knn_idx = ops.topk(sq, min(k + 1, n), dim=-1, largest=False)
            if n > 1:
                near, knn_idx = near[..., 1:], knn_idx[..., 1:]
            self_idx = torch.arange(n, device=dev)[:, None].expand_as(knn_idx)
            knn_idx = torch.where(near >= ops.INF, self_idx, knn_idx)
            ref_vec = points[knn_idx] - points[:, None, :]
            anc_vec = points[None, :, :] - points[:, None, :]
            shape = (n, n, k, 3)
            r = ref_vec[:, None, :, :].expand(shape)
            a = anc_vec[:, :, None, :].expand(shape)
            sin_v = torch.linalg.norm(torch.linalg.cross(r, a, dim=-1), dim=-1)
            cos_v = torch.sum(r * a, dim=-1)
            a_idx = torch.atan2(sin_v, cos_v) * (180.0 / (self.sigma_a * math.pi))
        hid = self.hidden
        d_emb = self.proj_d(sinusoidal_basis(d_idx, hid))
        a_emb = self.proj_a(sinusoidal_basis(a_idx, hid)).amax(dim=-2)
        return d_emb + a_emb


class GlobalRPESelfAttention(nn.Module):
    """Self attention over nodes with the geometric embedding e as relative
    position: scores (q.k + q.proj_p(e)) / sqrt(c) (the bias term of
    proj_p is constant along the keys and cancels in the softmax), hidden =
    A v, and positional states proj_vp(A' e), A' excluding the node itself."""

    def __init__(self, d, heads):
        super().__init__()
        self.d, self.heads = d, heads
        self.proj_q = nn.Linear(d, d)
        self.proj_k = nn.Linear(d, d)
        self.proj_v = nn.Linear(d, d)
        self.proj_p = nn.Linear(d, d)
        self.proj_vp = nn.Linear(d, d)

    def forward(self, x, embed, key_mask):
        n, d = x.shape
        h = self.heads
        c = d // h
        q = self.proj_q(x).reshape(n, h, c)
        k = self.proj_k(x).reshape(n, h, c)
        v = self.proj_v(x).reshape(n, h, c)
        qwp = torch.einsum("nhc,dhc->nhd", q, self.proj_p.weight.t().reshape(d, h, c))
        scores = (torch.einsum("nhc,mhc->hnm", q, k)
                  + torch.einsum("nhd,nmd->hnm", qwp, embed)) / math.sqrt(c)
        keep = key_mask[None, None, :]
        keep_pos = keep & ~torch.eye(n, dtype=torch.bool, device=x.device)
        hidden = torch.einsum("hnm,mhc->nhc", masked_softmax(scores, keep), v).reshape(n, d)
        ae = torch.einsum("hnm,nmd->nhd", masked_softmax(scores, keep_pos), embed)
        pos = (torch.einsum("nhd,dhc->nhc", ae, self.proj_vp.weight.t().reshape(d, h, c))
               + self.proj_vp.bias.reshape(h, c))
        return hidden, pos.reshape(n, d)


class RPEAttentionLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = GlobalRPESelfAttention(d, heads)
        self.linear = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)
        self.pos_linear = nn.Linear(d, d)
        self.pos_norm = nn.LayerNorm(d)

    def forward(self, x, embed, key_mask):
        hidden, pos = self.attention(x, embed, key_mask)
        return self.norm(self.linear(hidden) + x), self.pos_norm(self.pos_linear(pos))


class RPESelfLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = RPEAttentionLayer(d, heads)
        self.output = AttentionOutput(d)
        self.pos_proj = AttentionOutput(d)

    def forward(self, x, embed, key_mask):
        out, pos = self.attention(x, embed, key_mask)
        return self.output(out), self.pos_proj(pos)


class CrossAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.attention = nn.ModuleDict({n: nn.Linear(d, d) for n in ("proj_q", "proj_k", "proj_v")})
        self.linear = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, mem, pos_q, pos_k, key_mask):
        n, d = x.shape
        m = mem.shape[0]
        h = self.heads
        c = d // h
        att = self.attention
        q = att["proj_q"](x + pos_q).reshape(n, h, c)
        k = att["proj_k"](mem + pos_k).reshape(m, h, c)
        v = att["proj_v"](mem).reshape(m, h, c)
        scores = torch.einsum("nhc,mhc->hnm", q, k) / torch.tensor(math.sqrt(c)).item()
        attn = masked_softmax(scores, key_mask[None, None, :])
        hidden = torch.einsum("hnm,mhc->nhc", attn, v).reshape(n, d)
        return self.norm(self.linear(hidden) + x)


class CrossAttentionLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = CrossAttention(d, heads)
        self.output = AttentionOutput(d)

    def forward(self, x, mem, pos_q, pos_k, key_mask):
        return self.output(self.attention(x, mem, pos_q, pos_k, key_mask))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class GeometricTransformer(nn.Module):
    def __init__(self, d, heads, blocks):
        super().__init__()
        self.blocks = tuple(blocks)
        self.embedding = GeometricStructureEmbedding(d)
        self.in_proj = nn.Linear(d, d)
        self.transformer = _Stack([RPESelfLayer(d, heads) if b == "self"
                                   else CrossAttentionLayer(d, heads) for b in self.blocks])
        self.out_proj = nn.Linear(d, d)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_count, src_count,
                ref_masks, src_masks):
        ref_embed = self.embedding(ref_points, ref_count)
        src_embed = self.embedding(src_points, src_count)
        f0, f1 = self.in_proj(ref_feats), self.in_proj(src_feats)
        p0 = p1 = None
        for block, layer in zip(self.blocks, self.transformer.layers):
            if block == "self":
                f0, p0 = layer(f0, ref_embed, ref_masks)
                f1, p1 = layer(f1, src_embed, src_masks)
            else:
                f0 = layer(f0, f1, p0, p1, src_masks)
                f1 = layer(f1, f0, p1, p0, ref_masks)
        return self.out_proj(f0), self.out_proj(f1)


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        f = cfg.factor
        planes = [64 * f, 128 * f, 256 * f, 256 * f]
        heads = cfg.num_heads
        self.strides, self.nsample = tuple(cfg.enc_strides), tuple(cfg.enc_nsample)
        din = 1
        for lvl in range(4):
            p = planes[lvl]
            hid = min(p, 256 * f)
            stage = [TransitionDown(din, p, hid, heads, self.strides[lvl], self.nsample[lvl])]
            stage += [PointBlock(p, hid, heads) for _ in range(1, cfg.enc_blocks[lvl])]
            setattr(self, f"enc{lvl + 1}", nn.ModuleList(stage))
            din = p
        self.global_transformer = GeometricTransformer(planes[3], heads,
                                                       cfg.transformer_architecture)
        self.dec4 = nn.ModuleList([TransitionUpHead(planes[3]),
                                   PointBlock(planes[3], min(planes[3], 256 * f), heads)])
        for lvl in (3, 2, 1):
            p = planes[lvl - 1]
            setattr(self, f"dec{lvl}", nn.ModuleList([TransitionUp(planes[lvl], p),
                                                      PointBlock(p, min(p, 256 * f), heads)]))

    def encode(self, points, normals, feats, count, fps):
        levels = []
        p, nrm, x, cnt = points, normals, feats, count
        for lvl in range(4):
            stage = getattr(self, f"enc{lvl + 1}")
            p, nrm, x, cnt, down = stage[0](p, nrm, x, cnt, fps[lvl])
            gidx, _ = ops.masked_knn(p, p, cnt, self.nsample[lvl], exclude_self=True)
            mask = gidx < cnt
            ppf = ops.calc_ppf(p, nrm, p[gidx], nrm[gidx])
            for block in stage[1:]:
                x = block(x, gidx, ppf, mask)
            levels.append((p, x, cnt, gidx, ppf, mask, down))
        return levels

    def decode(self, levels):
        (p1, x1, c1, g1, f1, m1, _), (p2, x2, c2, g2, f2, m2, _), \
            (p3, x3, c3, g3, f3, m3, _), (p4, x4, c4, g4, f4, m4, _) = levels
        y4 = self.dec4[1](self.dec4[0](x4, c4), g4, f4, m4)
        y3 = self.dec3[1](self.dec3[0](p3, x3, p4, y4, c4), g3, f3, m3)
        y2 = self.dec2[1](self.dec2[0](p2, x2, p3, y3, c3), g2, f2, m2)
        return self.dec1[1](self.dec1[0](p1, x1, p2, y2, c2), g1, f1, m1)

    def forward(self, src_raw, src_normals, src_feats, src_count, tgt_points, tgt_normals,
                tgt_feats, tgt_count, src_points):
        with torch.no_grad():  # both clouds' FPS pyramids, sampled together
            pts = torch.stack([src_raw, tgt_points])
            cnt = torch.stack([src_count, tgt_count])
            fps = ([], [])
            for stride in self.strides:
                if stride == 1:
                    fps[0].append(None)
                    fps[1].append(None)
                    continue
                idx = ops.furthest_point_sampling(pts, cnt, pts.shape[1] // stride)
                fps[0].append(idx[0])
                fps[1].append(idx[1])
                pts = torch.gather(pts, 1, idx[:, :, None].expand(-1, -1, 3))
                cnt = ops.num_valid_samples(cnt, stride)
        s = self.encode(src_raw, src_normals, src_feats, src_count, fps[0])
        t = self.encode(tgt_points, tgt_normals, tgt_feats, tgt_count, fps[1])
        s4, t4 = s[3], t[3]
        s_mask4 = ops.prefix_mask(s4[0].shape[0], s4[2], device=s4[0].device)
        t_mask4 = ops.prefix_mask(t4[0].shape[0], t4[2], device=t4[0].device)
        s_g, t_g = self.global_transformer(s4[0], t4[0], s4[1], t4[1], s4[2], t4[2], s_mask4,
                                           t_mask4)
        s_x1, t_x1 = self.decode(s), self.decode(t)
        idx4_in_1 = s[1][6][s[2][6]][s[3][6]]
        return dict(src_nodes=src_points[idx4_in_1], src_node_feats=s_g, src_points=src_points,
                    src_point_feats=s_x1, src_node_count=s4[2], tgt_nodes=t4[0],
                    tgt_node_feats=t_g, tgt_points=t[0][0], tgt_point_feats=t_x1,
                    tgt_node_count=t4[2])


class LearnableLogOptimalTransport(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(1.0))


class RoITrReference(nn.Module):
    """The whole pipeline for one padded pair (prefix-packed clouds)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        f = cfg.factor
        self.backbone = Backbone(cfg)
        self.coarse_proj = nn.Linear(256 * f, 256 * f)
        self.fine_proj = nn.Linear(64 * f, 256 * f)
        self.optimal_transport = LearnableLogOptimalTransport()

    def forward(self, pair: Dict[str, torch.Tensor], train: bool = False, with_gt: bool = False,
                generator=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b = self.backbone(pair["src_raw_points"], pair["src_normals"], pair["src_feats"],
                          pair["src_count"], pair["tgt_points"], pair["tgt_normals"],
                          pair["tgt_feats"], pair["tgt_count"], pair["src_points"])
        out = {
            "src_nodes": b["src_nodes"], "tgt_nodes": b["tgt_nodes"],
            "src_point_feats": self.fine_proj(b["src_point_feats"]),
            "tgt_point_feats": self.fine_proj(b["tgt_point_feats"]),
            "src_node_feats": F.normalize(self.coarse_proj(b["src_node_feats"]), dim=-1,
                                          eps=1e-12),
            "tgt_node_feats": F.normalize(self.coarse_proj(b["tgt_node_feats"]), dim=-1,
                                          eps=1e-12),
            "src_count": pair["src_count"], "tgt_count": pair["tgt_count"],
            "src_node_count": b["src_node_count"], "tgt_node_count": b["tgt_node_count"],
        }
        src_points, tgt_points = b["src_points"], b["tgt_points"]
        sp = ops.point_to_node_partition(src_points, out["src_nodes"], cfg.point_per_patch,
                                         pair["src_count"], out["src_node_count"])
        tp = ops.point_to_node_partition(tgt_points, out["tgt_nodes"], cfg.point_per_patch,
                                         pair["tgt_count"], out["tgt_node_count"])
        zrow = src_points.new_zeros((1, 3))
        s_pad, t_pad = torch.cat([src_points, zrow]), torch.cat([tgt_points, zrow])
        s_knn_pts, t_knn_pts = s_pad[sp.node_knn_indices], t_pad[tp.node_knn_indices]
        if with_gt:
            gt = ops.node_correspondences(
                out["tgt_nodes"], out["src_nodes"], t_knn_pts, s_knn_pts, pair["rot"],
                pair["trans"], cfg.matching_radius, tp.node_masks, sp.node_masks,
                tp.node_knn_masks, sp.node_knn_masks, cfg.max_gt_corr_candidates)
            out["gt_node_corr_indices"], out["gt_node_corr_overlaps"] = gt.indices, gt.overlaps
            out["gt_node_corr_masks"] = gt.masks
        with torch.no_grad():
            tf, sf = out["tgt_node_feats"].detach(), out["src_node_feats"].detach()
            if cfg.is_rigid:
                est = ops.coarse_matching(tf, sf, tp.node_masks, sp.node_masks,
                                          cfg.num_est_coarse_corr)
            else:
                m = ops.adaptive_superpoint_matching(
                    sf, tf, sp.node_masks, tp.node_masks, cfg.num_est_coarse_corr,
                    cfg.coarse_corr_capacity or max(4 * cfg.num_est_coarse_corr, 512),
                    cfg.coarse_similarity_threshold)
                est = ops.CoarseCorr(m.src_indices, m.ref_indices, m.scores, m.masks)
        out["tgt_node_corr_indices"], out["src_node_corr_indices"] = est.ref_indices, est.src_indices
        out["node_corr_masks"] = est.masks
        corr = (ops.gt_coarse_corr_sample(gt, cfg.num_gt_coarse_corr,
                                          cfg.coarse_overlap_threshold, generator)
                if train else est)
        ti, si = corr.ref_indices, corr.src_indices
        t_knn_masks = tp.node_knn_masks[ti] & corr.masks[:, None]
        s_knn_masks = sp.node_knn_masks[si] & corr.masks[:, None]
        zfeat = out["src_point_feats"].new_zeros((1, out["src_point_feats"].shape[-1]))
        s_feats = torch.cat([out["src_point_feats"], zfeat])[sp.node_knn_indices[si]]
        t_feats = torch.cat([out["tgt_point_feats"], zfeat])[tp.node_knn_indices[ti]]
        out["src_node_corr_knn_points"], out["tgt_node_corr_knn_points"] = s_knn_pts[si], t_knn_pts[ti]
        out["src_node_corr_knn_masks"], out["tgt_node_corr_knn_masks"] = s_knn_masks, t_knn_masks
        scores = torch.einsum("pnc,pmc->pnm", t_feats, s_feats) / s_feats.shape[-1] ** 0.5
        scores = ops.log_sinkhorn_ot(scores, t_knn_masks, s_knn_masks,
                                     self.optimal_transport.alpha, cfg.sinkhorn_iters)
        out["matching_scores"] = scores
        with torch.no_grad():
            ref_pts, src_pts, conf, masks = ops.fine_matching(
                out["tgt_node_corr_knn_points"], out["src_node_corr_knn_points"], t_knn_masks,
                s_knn_masks, scores.detach()[:, :-1, :-1], corr.masks, cfg.fine_matching_topk,
                cfg.fine_matching_confidence_threshold)
        out.update(tgt_corr_points=ref_pts, src_corr_points=src_pts, corr_scores=conf,
                   corr_masks=masks)
        return out


# ------------------------------------------------------------------ losses

def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def coarse_loss(cfg, out):
    """Overlap-weighted circle loss over node descriptor distances (RoITr
    lib/loss.py:8-111), padded nodes out of every anchor set."""
    tf, sf = out["tgt_node_feats"], out["src_node_feats"]
    m, n = tf.shape[0], sf.shape[0]
    d = torch.sqrt(ops.pairwise_sq_dist(tf, sf))
    idx = out["gt_node_corr_indices"]
    ov = torch.where(out["gt_node_corr_masks"], out["gt_node_corr_overlaps"],
                     torch.zeros_like(out["gt_node_corr_overlaps"]))
    overlaps = torch.zeros((m, n), dtype=ov.dtype, device=ov.device).index_put_(
        (idx[:, 0], idx[:, 1]), ov, accumulate=True)
    pos = overlaps > cfg.coarse_loss_positive_overlap
    tv = ops.prefix_mask(m, out["tgt_node_count"], device=tf.device)
    sv = ops.prefix_mask(n, out["src_node_count"], device=tf.device)
    neg = (overlaps == 0.0) & tv[:, None] & sv[None, :]
    scales = torch.sqrt(overlaps * pos)
    rows = (pos.sum(-1) > 0) & (neg.sum(-1) > 0) & tv
    cols = (pos.sum(-2) > 0) & (neg.sum(-2) > 0) & sv
    pw = torch.clamp(d - 1e5 * (~pos).to(d.dtype) - cfg.coarse_loss_positive_optimal, min=0.0)
    pw = (pw * scales).detach()
    nw = torch.clamp(cfg.coarse_loss_negative_optimal - (d + 1e5 * (~neg).to(d.dtype)),
                     min=0.0).detach()
    s = cfg.coarse_loss_log_scale
    lp = s * (d - cfg.coarse_loss_positive_margin) * pw
    ln = s * (cfg.coarse_loss_negative_margin - d) * nw
    row = F.softplus(torch.logsumexp(lp, dim=-1) + torch.logsumexp(ln, dim=-1)) / s
    col = F.softplus(torch.logsumexp(lp, dim=-2) + torch.logsumexp(ln, dim=-2)) / s
    return (_masked_mean(row, rows) + _masked_mean(col, cols)) / 2.0


def fine_loss(cfg, out, rot, trans):
    """Negative mean OT log-score over the GT point matches and the slack
    labels (RoITr lib/loss.py:114-143)."""
    tm, sm = out["tgt_node_corr_knn_masks"], out["src_node_corr_knn_masks"]
    scores = out["matching_scores"]
    src = ops.apply_transform(out["src_node_corr_knn_points"], rot, trans)
    d = ops.pairwise_sq_dist(out["tgt_node_corr_knn_points"], src)
    gt = (d < cfg.fine_loss_positive_radius ** 2) & tm[:, :, None] & sm[:, None, :]
    k = tm.shape[1]
    labels = torch.zeros_like(scores, dtype=torch.bool)
    labels[:, :k, :k] = gt
    labels[:, :k, k] = (gt.sum(2) == 0) & tm
    labels[:, k, :k] = (gt.sum(1) == 0) & sm
    return -_masked_mean(scores, labels)


def loss(cfg, out, rot, trans):
    return (cfg.coarse_loss_weight * coarse_loss(cfg, out)
            + cfg.fine_loss_weight * fine_loss(cfg, out, rot, trans))
