"""GeoTransformer's KPConv-FPN backbone (geotransformer/modules/kpconv).

Every stage holds both clouds stacked (ops/grid.py `GridPyramid`), as
upstream does, so a block runs once for the pair and GroupNorm's
statistics span both clouds. Neighbour indices past a stage's rows point
at a shadow row: far away (1e6) for the kernel-point weights, zero
features for the gathers.

- KPConv: y = s[idx] - q; w_{k,h} = max(0, 1 - |y_h - kp_k| / sigma);
  out = sum_k (sum_h w_{k,h} x[idx_h]) W_k, divided by the count of
  neighbours whose features sum above zero (at least 1), plus a bias.
- UnaryBlock: Linear, GroupNorm, LeakyReLU(0.1) (the last left out when
  has_relu is False); LastUnaryBlock: the Linear alone.
- ConvBlock: KPConv without bias, GroupNorm, LeakyReLU.
- ResidualBlock: Unary to a quarter of the output width (skipped when the
  input has it), KPConv with bias, GroupNorm, LeakyReLU, Unary without
  relu; the shortcut max-pools the neighbours when strided and projects
  when the widths differ; LeakyReLU of the sum.

Plain torch on the card: gathers, batched products for the contractions.
Each KPConv runs in a `kpconv` span. Module names follow upstream's
state_dict.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from roitr_torch.utils.profiling import span

_SHADOW = 1e6
_SLOPE = 0.1


def kernel_disposition(num_points: int = 15, seed: int = 0, iterations: int = 1000,
                       ratio: float = 0.66) -> np.ndarray:
    """(num_points, 3) kernel points in the unit ball, the first at the
    centre: KPConv's repulsion disposition (`kernel_point_optimization_debug`
    with fixed='center', one candidate), then a random rotation and a little
    noise as `load_kernels` draws them, all from `seed`."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((num_points, 3))
    found = 1
    while found < num_points:  # uniform in the shell 0.5 < |p|^2 < 0.81
        cand = rng.rand(3) * 2 - 1
        d2 = float(np.sum(cand ** 2))
        if 0.5 < d2 < 0.81:
            pts[found] = cand
            found += 1
    step, clip = 1e-2, 0.05
    for _ in range(iterations):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = np.sum(diff ** 2, axis=-1)
        grads = np.sum(diff / (d2[..., None] ** 1.5 + 1e-6), axis=1) + 10 * pts
        norms = np.linalg.norm(grads, axis=-1)
        move = np.minimum(step * norms, clip)
        move[0] = 0.0
        pts -= (move / (norms + 1e-6))[:, None] * grads
        step *= 0.9995
    pts *= ratio / np.mean(np.linalg.norm(pts[1:], axis=-1))
    theta, phi, alpha = rng.rand() * 2 * np.pi, (rng.rand() - 0.5) * np.pi, rng.rand() * 2 * np.pi
    u = np.array([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    rot = np.eye(3) + np.sin(alpha) * k + (1 - np.cos(alpha)) * (k @ k)
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    return (pts @ rot).astype(np.float32)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, mask: Optional[torch.Tensor] = None):
    """GroupNorm of rows x (N, C) with statistics over every row (both
    clouds of a stacked stage), or over the rows `mask` keeps, as upstream
    normalises its stacked (1, C, N) tensor."""
    if mask is None:
        return F.group_norm(x.t()[None], norm.num_groups, norm.weight, norm.bias,
                            norm.eps)[0].t()
    n, c = x.shape
    g = norm.num_groups
    xg = x.reshape(n, g, c // g)
    w = mask.to(x.dtype)[:, None, None]
    cnt = torch.clamp(mask.sum(), min=1).to(x.dtype) * (c // g)
    mean = (xg * w).sum(dim=(0, 2)) / cnt
    var = (((xg - mean[None, :, None]) ** 2) * w).sum(dim=(0, 2)) / cnt
    y = (xg - mean[None, :, None]) / torch.sqrt(var + norm.eps)[None, :, None]
    return y.reshape(n, c) * norm.weight + norm.bias


class GroupNorm(nn.Module):
    """Holds the nn.GroupNorm under upstream's `norm.norm` keys."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels)

    def forward(self, x, mask=None):
        return group_norm(x, self.norm, mask)


class KPConv(nn.Module):
    """Rigid kernel-point convolution (KPConv, Thomas et al. 2019) with
    upstream's density normalisation. The kernel points are a buffer of
    the state dict."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, radius: float,
                 sigma: float, bias: bool = False, seed: int = 0):
        super().__init__()
        self.sigma = sigma
        self.weights = nn.Parameter(torch.zeros(kernel_size, 1, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer("kernel_points", torch.from_numpy(
            kernel_disposition(kernel_size, seed) * radius))

    def forward(self, s_feats, q_points, s_points, neighbor_indices):
        with span("kpconv", q_points.device):
            m, h = neighbor_indices.shape
            kk, _, cin, cout = self.weights.shape
            s_pad = torch.cat([s_points, s_points.new_full((1, 3), _SHADOW)])
            rel = s_pad[neighbor_indices] - q_points[:, None, :]  # (M, H, 3)
            diff = rel[:, :, None, :] - self.kernel_points  # (M, H, K, 3)
            dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
            w = torch.clamp(1.0 - dist / self.sigma, min=0.0).transpose(1, 2)  # (M, K, H)
            f_pad = torch.cat([s_feats, s_feats.new_zeros((1, cin))])
            nf = f_pad[neighbor_indices]  # (M, H, C)
            weighted = torch.matmul(w, nf)  # (M, K, C)
            out = weighted.reshape(m, kk * cin) @ self.weights.reshape(kk * cin, cout)
            num = torch.clamp((nf.sum(dim=-1) > 0.0).sum(dim=-1), min=1)
            out = out / num[:, None].to(out.dtype)
            if self.bias is not None:
                out = out + self.bias
            return out


def maxpool(x: torch.Tensor, neighbor_indices: torch.Tensor) -> torch.Tensor:
    """Max over each query's neighbours' features, the shadow row zero."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad[neighbor_indices].amax(dim=1)


def nearest_upsample(x: torch.Tensor, upsample_indices: torch.Tensor) -> torch.Tensor:
    """The features of each query's nearest coarser point (shadow: zero)."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad[upsample_indices[:, 0]]


class UnaryBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int, has_relu: bool = True):
        super().__init__()
        self.has_relu = has_relu
        self.mlp = nn.Linear(in_channels, out_channels)
        self.norm = GroupNorm(groups, out_channels)

    def forward(self, x):
        x = self.norm(self.mlp(x))
        return F.leaky_relu(x, _SLOPE) if self.has_relu else x


class LastUnaryBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels)

    def forward(self, x):
        return self.mlp(x)


class ConvBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, groups, seed=0):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma, bias=False,
                             seed=seed)
        self.norm = GroupNorm(groups, out_channels)

    def forward(self, s_feats, q_points, s_points, neighbor_indices):
        x = self.KPConv(s_feats, q_points, s_points, neighbor_indices)
        return F.leaky_relu(self.norm(x), _SLOPE)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma, groups,
                 strided: bool = False, seed: int = 0):
        super().__init__()
        self.strided = strided
        mid = out_channels // 4
        self.unary1 = (UnaryBlock(in_channels, mid, groups) if in_channels != mid
                       else nn.Identity())
        self.KPConv = KPConv(mid, mid, kernel_size, radius, sigma, bias=True, seed=seed)
        self.norm_conv = GroupNorm(groups, mid)
        self.unary2 = UnaryBlock(mid, out_channels, groups, has_relu=False)
        self.unary_shortcut = (UnaryBlock(in_channels, out_channels, groups, has_relu=False)
                               if in_channels != out_channels else nn.Identity())

    def forward(self, s_feats, q_points, s_points, neighbor_indices):
        x = self.unary1(s_feats)
        x = self.KPConv(x, q_points, s_points, neighbor_indices)
        x = self.unary2(F.leaky_relu(self.norm_conv(x), _SLOPE))
        shortcut = maxpool(s_feats, neighbor_indices) if self.strided else s_feats
        return F.leaky_relu(x + self.unary_shortcut(shortcut), _SLOPE)


class KPConvFPN(nn.Module):
    """Four encoder stages of 2 + 3 + 3 + 3 blocks (widths init_dim to 16
    init_dim) and two decoder steps back to stage 2 (GeoTransformer's
    3DMatch backbone). forward -> (fine features at stage 2, output_dim
    wide; coarse features at stage 4, 16 init_dim wide)."""

    def __init__(self, input_dim: int, output_dim: int, init_dim: int, kernel_size: int,
                 init_radius: float, init_sigma: float, groups: int):
        super().__init__()
        d, r, s, k, g = init_dim, init_radius, init_sigma, kernel_size, groups
        self.encoder1_1 = ConvBlock(input_dim, d, k, r, s, g, seed=11)
        self.encoder1_2 = ResidualBlock(d, 2 * d, k, r, s, g, seed=12)
        self.encoder2_1 = ResidualBlock(2 * d, 2 * d, k, r, s, g, strided=True, seed=21)
        self.encoder2_2 = ResidualBlock(2 * d, 4 * d, k, 2 * r, 2 * s, g, seed=22)
        self.encoder2_3 = ResidualBlock(4 * d, 4 * d, k, 2 * r, 2 * s, g, seed=23)
        self.encoder3_1 = ResidualBlock(4 * d, 4 * d, k, 2 * r, 2 * s, g, strided=True, seed=31)
        self.encoder3_2 = ResidualBlock(4 * d, 8 * d, k, 4 * r, 4 * s, g, seed=32)
        self.encoder3_3 = ResidualBlock(8 * d, 8 * d, k, 4 * r, 4 * s, g, seed=33)
        self.encoder4_1 = ResidualBlock(8 * d, 8 * d, k, 4 * r, 4 * s, g, strided=True, seed=41)
        self.encoder4_2 = ResidualBlock(8 * d, 16 * d, k, 8 * r, 8 * s, g, seed=42)
        self.encoder4_3 = ResidualBlock(16 * d, 16 * d, k, 8 * r, 8 * s, g, seed=43)
        self.decoder3 = UnaryBlock(24 * d, 8 * d, g)
        self.decoder2 = LastUnaryBlock(12 * d, output_dim)

    def forward(self, feats, pyr):
        p, nb, sub, up = pyr.points, pyr.neighbors, pyr.subsampling, pyr.upsampling
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


def init_kpconv_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of the KPConv weights and biases: uniform in
    +-1/sqrt(kernel_size * in_channels)."""
    for m in module.modules():
        if isinstance(m, KPConv):
            kk, _, cin, _ = m.weights.shape
            bound = 1.0 / math.sqrt(kk * cin)
            with torch.no_grad():
                m.weights.copy_(torch.rand(m.weights.shape, generator=generator) * 2 * bound
                                - bound)
                if m.bias is not None:
                    m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 2 * bound
                                 - bound)
