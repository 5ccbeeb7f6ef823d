"""GeoTransformer (qinzheng93/GeoTransformer, experiment
geotransformer.3dmatch.stage4.gse.k3.max.oacl.stage2.sinkhorn) in plain
PyTorch, fp32, one pair: the grid pyramid and radius searches, the
KPConv-FPN backbone, the geometric transformer, the matching head and
local-to-global registration, written as upstream's modules compute them
(KPConv's einsum over the kernel points, GroupNorm of the stacked (1, C, N)
tensor, the RPE scores from the projected (N, N, d) embedding, LGR over
padded patch batches with torch.linalg.svd). Module names follow
upstream's state_dict. This file imports nothing of the program.

Departures from upstream, stated:
- node order: a stage's nodes are ordered by voxel key (z, then y, then
  x; keys floor(p / voxel)), where upstream's follow a hash map;
  barycentres are means in fixed point (2^-32 m, exact sums) rounded to
  fp32 once, where upstream sums in fp32;
- kernel points: each KPConv's are a buffer of the state dict, drawn from
  the run's seed (the benchmark's model module), where upstream draws a
  rotation of a stored disposition at random;
- the fine matching confidence threshold is the configuration's (0.0 in
  the benchmark, for 0.05: random weights give a near-uniform plan);
- inference only; the ground-truth, loss and training modules are left out.
"""

from __future__ import annotations

import types
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops
from portbench.reference.model import AttentionOutput, GeometricStructureEmbedding, masked_softmax

SHADOW = 1e6
FIXED = 2.0 ** 32


def config(values: Mapping) -> types.SimpleNamespace:
    return types.SimpleNamespace(**dict(values))


# ------------------------------------------------------------ grid pyramid

def grid_subsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Barycentres of one cloud's occupied voxels, ordered by (z, y, x)
    voxel key: the mean of the points in units of 2^-32 m (exact int64
    sums), rounded to fp32."""
    v = np.floor(points / np.float32(voxel)).astype(np.int64)
    order = np.lexsort((v[:, 0], v[:, 1], v[:, 2]))
    vs = v[order]
    start = np.ones(len(vs), dtype=bool)
    start[1:] = np.any(vs[1:] != vs[:-1], axis=1)
    first = np.nonzero(start)[0]
    fixed = np.round(points[order].astype(np.float64) * FIXED).astype(np.int64)
    sums = np.add.reduceat(fixed, first, axis=0)
    counts = np.diff(np.append(first, len(vs)))
    return (sums.astype(np.float64) / counts[:, None] / FIXED).astype(np.float32)


def radius_search(queries: torch.Tensor, keys: torch.Tensor, radius: float,
                  limit: int) -> torch.Tensor:
    """One cloud's nearest keys below the radius, at most `limit`,
    ascending, ties to the lower index; empty slots hold len(keys)."""
    n = keys.shape[0]
    idx, dist = ops.masked_knn(queries, keys, n, min(limit, n))
    idx = torch.where(dist < radius, idx, torch.full_like(idx, n))
    if idx.shape[1] < limit:
        idx = torch.cat([idx, idx.new_full((idx.shape[0], limit - idx.shape[1]), n)], dim=1)
    return idx


def stacked_search(queries: List[torch.Tensor], keys: List[torch.Tensor], radius: float,
                   limit: int) -> torch.Tensor:
    """The search of each cloud (reference, source), as indices into the
    stacked keys with the shadow at their total."""
    total = keys[0].shape[0] + keys[1].shape[0]
    out = []
    for i, (q, k) in enumerate(zip(queries, keys)):
        idx = radius_search(q, k, radius, limit)
        shift = 0 if i == 0 else keys[0].shape[0]
        out.append(torch.where(idx == k.shape[0], torch.full_like(idx, total), idx + shift))
    return torch.cat(out)


def pyramid(cfg, ref: np.ndarray, src: np.ndarray, device) -> dict:
    """Stages (each both clouds stacked, reference first), their lengths and
    searches: neighbors[s], subsampling[s] (stage s + 1 in stage s),
    upsampling[s] (stage s in stage s + 1, the nearest within 2 r_s)."""
    clouds = [[ref.astype(np.float32), src.astype(np.float32)]]
    voxel = cfg.voxel_size
    for _ in range(1, cfg.num_stages):
        voxel *= 2
        clouds.append([grid_subsample(c, voxel) for c in clouds[-1]])
    per = [[torch.from_numpy(np.ascontiguousarray(c)).to(device) for c in cs] for cs in clouds]
    out = {"points": [torch.cat(p) for p in per],
           "lengths": [(len(a), len(b)) for a, b in clouds],
           "neighbors": [], "subsampling": [], "upsampling": {}}
    for s in range(cfg.num_stages):
        r = cfg.base_radius * cfg.voxel_size * 2 ** s
        lim = cfg.neighbor_limits[s]
        out["neighbors"].append(stacked_search(per[s], per[s], r, lim))
        if s + 1 < cfg.num_stages:
            out["subsampling"].append(stacked_search(per[s + 1], per[s], r, lim))
            out["upsampling"][s] = stacked_search(per[s], per[s + 1], 2 * r, 1)
    return out


# ----------------------------------------------------------------- KPConv

class KPConv(nn.Module):
    def __init__(self, cin, cout, kernel_size, radius, sigma, bias):
        super().__init__()
        self.radius, self.sigma = radius, sigma
        self.weights = nn.Parameter(torch.zeros(kernel_size, 1, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("kernel_points", torch.zeros(kernel_size, 3))

    def forward(self, s_feats, q_points, s_points, neighbor_indices):
        s_points = torch.cat((s_points, torch.zeros_like(s_points[:1, :]) + SHADOW), 0)
        neighbors = s_points[neighbor_indices, :] - q_points.unsqueeze(1)
        differences = neighbors.unsqueeze(2) - self.kernel_points
        sq_distances = torch.sum(differences ** 2, dim=3)
        neighbor_weights = torch.clamp(1 - torch.sqrt(sq_distances) / self.sigma, min=0.0)
        neighbor_weights = torch.transpose(neighbor_weights, 1, 2)
        padded = torch.cat((s_feats, torch.zeros_like(s_feats[:1, :])), 0)
        neighbor_feats = padded[neighbor_indices, :]
        weighted = torch.matmul(neighbor_weights, neighbor_feats)
        weighted = weighted.view(-1, self.weights.shape[0], 1, self.weights.shape[2])
        out = torch.einsum("mkgc,kgcd->mgd", weighted, self.weights)
        out = out.reshape(-1, self.weights.shape[3])
        num = torch.sum(torch.gt(torch.sum(neighbor_feats, dim=-1), 0.0), dim=-1)
        num = torch.max(num, torch.ones_like(num))
        out = out / num.unsqueeze(1)
        if self.bias is not None:
            out = out + self.bias
        return out


class GroupNorm(nn.Module):
    def __init__(self, groups, channels):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels)

    def forward(self, x):
        return self.norm(x.transpose(0, 1).unsqueeze(0)).squeeze(0).transpose(0, 1)


class UnaryBlock(nn.Module):
    def __init__(self, cin, cout, groups, has_relu=True):
        super().__init__()
        self.has_relu = has_relu
        self.mlp = nn.Linear(cin, cout)
        self.norm = GroupNorm(groups, cout)

    def forward(self, x):
        x = self.norm(self.mlp(x))
        return F.leaky_relu(x, 0.1) if self.has_relu else x


class LastUnaryBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.mlp = nn.Linear(cin, cout)

    def forward(self, x):
        return self.mlp(x)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k, r, s, g):
        super().__init__()
        self.KPConv = KPConv(cin, cout, k, r, s, bias=False)
        self.norm = GroupNorm(g, cout)

    def forward(self, s_feats, q_points, s_points, idx):
        return F.leaky_relu(self.norm(self.KPConv(s_feats, q_points, s_points, idx)), 0.1)


def maxpool(x, idx):
    x = torch.cat((x, torch.zeros_like(x[:1, :])), 0)
    return x[idx].max(1)[0]


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, k, r, s, g, strided=False):
        super().__init__()
        self.strided = strided
        mid = cout // 4
        self.unary1 = UnaryBlock(cin, mid, g) if cin != mid else nn.Identity()
        self.KPConv = KPConv(mid, mid, k, r, s, bias=True)
        self.norm_conv = GroupNorm(g, mid)
        self.unary2 = UnaryBlock(mid, cout, g, has_relu=False)
        self.unary_shortcut = (UnaryBlock(cin, cout, g, has_relu=False) if cin != cout
                               else nn.Identity())

    def forward(self, s_feats, q_points, s_points, idx):
        x = self.unary1(s_feats)
        x = self.KPConv(x, q_points, s_points, idx)
        x = F.leaky_relu(self.norm_conv(x), 0.1)
        x = self.unary2(x)
        shortcut = maxpool(s_feats, idx) if self.strided else s_feats
        return F.leaky_relu(x + self.unary_shortcut(shortcut), 0.1)


def nearest_upsample(x, idx):
    x = torch.cat((x, torch.zeros_like(x[:1, :])), 0)
    return x[idx[:, 0]]


class KPConvFPN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, k, g = cfg.init_dim, cfg.kernel_size, cfg.group_norm
        r, s = cfg.base_radius * cfg.voxel_size, cfg.base_sigma * cfg.voxel_size
        self.encoder1_1 = ConvBlock(1, d, k, r, s, g)
        self.encoder1_2 = ResidualBlock(d, 2 * d, k, r, s, g)
        self.encoder2_1 = ResidualBlock(2 * d, 2 * d, k, r, s, g, strided=True)
        self.encoder2_2 = ResidualBlock(2 * d, 4 * d, k, 2 * r, 2 * s, g)
        self.encoder2_3 = ResidualBlock(4 * d, 4 * d, k, 2 * r, 2 * s, g)
        self.encoder3_1 = ResidualBlock(4 * d, 4 * d, k, 2 * r, 2 * s, g, strided=True)
        self.encoder3_2 = ResidualBlock(4 * d, 8 * d, k, 4 * r, 4 * s, g)
        self.encoder3_3 = ResidualBlock(8 * d, 8 * d, k, 4 * r, 4 * s, g)
        self.encoder4_1 = ResidualBlock(8 * d, 8 * d, k, 4 * r, 4 * s, g, strided=True)
        self.encoder4_2 = ResidualBlock(8 * d, 16 * d, k, 8 * r, 8 * s, g)
        self.encoder4_3 = ResidualBlock(16 * d, 16 * d, k, 8 * r, 8 * s, g)
        self.decoder3 = UnaryBlock(24 * d, 8 * d, g)
        self.decoder2 = LastUnaryBlock(12 * d, cfg.output_dim)

    def forward(self, feats, pyr):
        p, nb, sub, up = pyr["points"], pyr["neighbors"], pyr["subsampling"], pyr["upsampling"]
        f1 = self.encoder1_1(feats, p[0], p[0], nb[0])
        f1 = self.encoder1_2(f1, p[0], p[0], nb[0])
        f2 = self.encoder2_1(f1, p[1], p[0], sub[0])
        f2 = self.encoder2_2(f2, p[1], p[1], nb[1])
        f2 = self.encoder2_3(f2, p[1], p[1], nb[1])
        f3 = self.encoder3_1(f2, p[2], p[1], sub[1])
        f3 = self.encoder3_2(f3, p[2], p[2], nb[2])
        f3 = self.encoder3_3(f3, p[2], p[2], nb[2])
        f4 = self.encoder4_1(f3, p[3], p[2], sub[2])
        f4 = self.encoder4_2(f4, p[3], p[3], nb[3])
        f4 = self.encoder4_3(f4, p[3], p[3], nb[3])
        l3 = self.decoder3(torch.cat([nearest_upsample(f4, up[2]), f3], dim=1))
        l2 = self.decoder2(torch.cat([nearest_upsample(l3, up[1]), f2], dim=1))
        return l2, f4


# ------------------------------------------------------------ transformer

class RPEMultiHeadAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.proj_q, self.proj_k = nn.Linear(d, d), nn.Linear(d, d)
        self.proj_v, self.proj_p = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, embed):
        n, d = x.shape
        h, c = self.heads, d // self.heads
        q = self.proj_q(x).reshape(n, h, c)
        k = self.proj_k(x).reshape(n, h, c)
        v = self.proj_v(x).reshape(n, h, c)
        p = self.proj_p(embed).reshape(n, n, h, c)
        scores = (torch.einsum("nhc,mhc->hnm", q, k) + torch.einsum("nhc,nmhc->hnm", q, p))
        attn = torch.softmax(scores / c ** 0.5, dim=-1)
        return torch.einsum("hnm,mhc->nhc", attn, v).reshape(n, d)


class RPEAttentionLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = RPEMultiHeadAttention(d, heads)
        self.linear = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, embed):
        return self.norm(self.linear(self.attention(x, embed)) + x)


class RPETransformerLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = RPEAttentionLayer(d, heads)
        self.output = AttentionOutput(d)

    def forward(self, x, embed):
        return self.output(self.attention(x, embed))


class CrossAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.attention = nn.ModuleDict({n: nn.Linear(d, d) for n in ("proj_q", "proj_k", "proj_v")})
        self.linear = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, mem):
        n, d = x.shape
        h, c = self.heads, d // self.heads
        att = self.attention
        q = att["proj_q"](x).reshape(n, h, c)
        k = att["proj_k"](mem).reshape(-1, h, c)
        v = att["proj_v"](mem).reshape(-1, h, c)
        attn = masked_softmax(torch.einsum("nhc,mhc->hnm", q, k) / c ** 0.5, None)
        hidden = torch.einsum("hnm,mhc->nhc", attn, v).reshape(n, d)
        return self.norm(self.linear(hidden) + x)


class CrossTransformerLayer(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.attention = CrossAttention(d, heads)
        self.output = AttentionOutput(d)

    def forward(self, x, mem):
        return self.output(self.attention(x, mem))


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class GeometricTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.blocks = tuple(cfg.transformer_architecture)
        self.embedding = GeometricStructureEmbedding(256, 0.2, 15.0, 3)
        self.in_proj = nn.Linear(cfg.transformer_input_dim, 256)
        self.transformer = _Stack([RPETransformerLayer(256, cfg.num_heads) if b == "self"
                                   else CrossTransformerLayer(256, cfg.num_heads)
                                   for b in self.blocks])
        self.out_proj = nn.Linear(256, 256)

    def forward(self, ref_points, src_points, ref_feats, src_feats):
        e0 = self.embedding(ref_points, ref_points.shape[0])
        e1 = self.embedding(src_points, src_points.shape[0])
        f0, f1 = self.in_proj(ref_feats), self.in_proj(src_feats)
        for block, layer in zip(self.blocks, self.transformer.layers):
            if block == "self":
                f0, f1 = layer(f0, e0), layer(f1, e1)
            else:
                f0 = layer(f0, f1)
                f1 = layer(f1, f0)
        return self.out_proj(f0), self.out_proj(f1)


# ------------------------------------------------------------ registration

def weighted_procrustes(src, ref, weights, eps=1e-5):
    """GeoTransformer's WeightedProcrustes: (B, C, 3) x2, (B, C) -> (B, 4, 4)."""
    weights = weights * torch.gt(weights, 0.0).float()
    weights = weights / (torch.sum(weights, dim=1, keepdim=True) + eps)
    weights = weights.unsqueeze(2)
    src_centroid = torch.sum(src * weights, dim=1, keepdim=True)
    ref_centroid = torch.sum(ref * weights, dim=1, keepdim=True)
    h = (src - src_centroid).permute(0, 2, 1) @ (weights * (ref - ref_centroid))
    u, _, vh = torch.linalg.svd(h)
    v, ut = vh.transpose(1, 2), u.transpose(1, 2)
    eye = torch.eye(3, device=h.device).unsqueeze(0).repeat(h.shape[0], 1, 1)
    eye[:, -1, -1] = torch.sign(torch.det(v @ ut))
    rot = v @ eye @ ut
    trans = ref_centroid.permute(0, 2, 1) - rot @ src_centroid.permute(0, 2, 1)
    out = torch.eye(4, device=h.device).unsqueeze(0).repeat(h.shape[0], 1, 1)
    out[:, :3, :3] = rot
    out[:, :3, 3] = trans.squeeze(2)
    return out


def apply_transform(points, transform):
    return points @ transform[:3, :3].t() + transform[:3, 3]


def local_to_global(ref_knn, src_knn, score_mat, corr_mat, cfg, chunk: int = 64):
    """Upstream's local_to_global_registration: the global correspondences,
    a hypothesis from each patch of at least the threshold's count (padded
    batches of `chunk` patches), the one with the most inliers, and the
    refinement rounds."""
    b, r, s = torch.nonzero(corr_mat, as_tuple=True)
    g_ref, g_src, g_scores = ref_knn[b, r], src_knn[b, s], score_mat[b, r, s]
    radius = cfg.acceptance_radius
    num = corr_mat.sum(dim=(1, 2))
    patches = torch.nonzero(num >= cfg.fine_matching_correspondence_threshold)[:, 0]

    def rescore(transform):
        res = torch.linalg.norm(g_ref - apply_transform(g_src, transform), dim=1)
        return g_scores * torch.lt(res, radius).float()

    if patches.numel() > 0:
        transform, best_count = None, -1
        for c0 in range(0, patches.numel(), chunk):
            sel = patches[c0:c0 + chunk]
            width = int(num[sel].max())
            pr = torch.zeros((len(sel), width, 3), device=ref_knn.device)
            ps, pw = torch.zeros_like(pr), torch.zeros((len(sel), width), device=ref_knn.device)
            for j, p in enumerate(sel.tolist()):
                rr, ss = torch.nonzero(corr_mat[p], as_tuple=True)
                pr[j, :len(rr)], ps[j, :len(rr)] = ref_knn[p, rr], src_knn[p, ss]
                pw[j, :len(rr)] = score_mat[p, rr, ss]
            transforms = weighted_procrustes(ps, pr, pw)
            moved = g_src[None] @ transforms[:, :3, :3].transpose(1, 2) + transforms[:, None, :3, 3]
            counts = torch.lt(torch.linalg.norm(g_ref[None] - moved, dim=2), radius).sum(dim=1)
            top = int(torch.argmax(counts))
            if int(counts[top]) > best_count:
                transform, best_count = transforms[top], int(counts[top])
    else:  # no patch of the threshold's count: start from every correspondence
        transform = weighted_procrustes(g_src[None], g_ref[None], g_scores[None])[0]
    for _ in range(cfg.num_refinement_steps):
        transform = weighted_procrustes(g_src[None], g_ref[None], rescore(transform)[None])[0]
    return g_ref, g_src, g_scores, transform


# ------------------------------------------------------------------- model

class LearnableLogOptimalTransport(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(1.0))


class GeoTransformerReference(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = KPConvFPN(cfg)
        self.transformer = GeometricTransformer(cfg)
        self.optimal_transport = LearnableLogOptimalTransport()

    def forward(self, pyr: dict) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        (rf, _), (rc, _) = pyr["lengths"][1], pyr["lengths"][3]
        points_f, points_c = pyr["points"][1], pyr["points"][3]
        feats = torch.ones((pyr["points"][0].shape[0], 1), device=points_f.device)
        feats_f, feats_c = self.backbone(feats, pyr)
        ref_c, src_c = self.transformer(points_c[:rc], points_c[rc:], feats_c[:rc], feats_c[rc:])
        ref_c, src_c = F.normalize(ref_c, p=2, dim=1), F.normalize(src_c, p=2, dim=1)
        ref_f, src_f = points_f[:rf], points_f[rf:]
        nr, ns = points_c[:rc].shape[0], points_c[rc:].shape[0]
        rp = ops.point_to_node_partition(ref_f, points_c[:rc], cfg.point_per_patch, len(ref_f), nr)
        sp = ops.point_to_node_partition(src_f, points_c[rc:], cfg.point_per_patch, len(src_f), ns)
        corr = ops.coarse_matching(ref_c, src_c, rp.node_masks, sp.node_masks,
                                   cfg.num_est_coarse_corr)
        ri, si = rp.node_knn_indices[corr.ref_indices], sp.node_knn_indices[corr.src_indices]
        zrow = points_f.new_zeros((1, 3))
        ref_knn = torch.cat([ref_f, zrow])[ri]
        src_knn = torch.cat([src_f, zrow])[si]
        rm = rp.node_knn_masks[corr.ref_indices] & corr.masks[:, None]
        sm = sp.node_knn_masks[corr.src_indices] & corr.masks[:, None]
        zf = feats_f.new_zeros((1, feats_f.shape[1]))
        rkf, skf = torch.cat([feats_f[:rf], zf])[ri], torch.cat([feats_f[rf:], zf])[si]
        scores = torch.einsum("bnd,bmd->bnm", rkf, skf) / feats_f.shape[1] ** 0.5
        scores = ops.log_sinkhorn_ot(scores, rm, sm, self.optimal_transport.alpha,
                                     cfg.sinkhorn_iters)[:, :-1, :-1]
        score_mat = torch.exp(scores)
        k = cfg.fine_matching_topk
        corr_mat = torch.gt(score_mat, cfg.fine_matching_confidence_threshold)
        corr_mat &= rm[:, :, None] & sm[:, None, :]

        def topk_mask(dim):
            _, i = ops.topk(score_mat, k, dim=dim)
            return torch.zeros_like(corr_mat).scatter(dim, i, True)

        corr_mat &= topk_mask(2) & topk_mask(1) & corr.masks[:, None, None]
        g_ref, g_src, g_scores, transform = local_to_global(ref_knn, src_knn, score_mat,
                                                            corr_mat, cfg)
        return {"tgt_points": ref_f, "src_points": src_f, "tgt_nodes": points_c[:rc],
                "src_nodes": points_c[rc:], "tgt_point_desc": feats_f[:rf],
                "src_point_desc": feats_f[rf:], "tgt_node_desc": ref_c, "src_node_desc": src_c,
                "tgt_corr_pts": g_ref, "src_corr_pts": g_src, "confidence": g_scores,
                "transform": transform}


def build(cfg, state_dict: Mapping[str, torch.Tensor], device) -> GeoTransformerReference:
    model = GeoTransformerReference(cfg).to(device)
    model.load_state_dict(state_dict)
    return model


@torch.no_grad()
def match(model: GeoTransformerReference, cfg, src: np.ndarray, tgt: np.ndarray,
          device) -> Dict[str, np.ndarray]:
    """A request (the target is the reference cloud): every output the
    benchmark compares, as numpy."""
    out = model(pyramid(cfg, tgt, src, device))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def inliers_of(out: Mapping[str, np.ndarray], transform: np.ndarray, radius: float) -> int:
    """The correspondences of `out` within `radius` under `transform`."""
    moved = out["src_corr_pts"] @ transform[:3, :3].T + transform[:3, 3]
    return int((np.linalg.norm(out["tgt_corr_pts"] - moved, axis=1) < radius).sum())

