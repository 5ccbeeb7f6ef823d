"""GeoTransformer (qinzheng93/GeoTransformer, geotransformer.3dmatch.stage4.
gse.k3.max.oacl.stage2.sinkhorn): the reference's configuration and model
(`portbench/reference/geotransformer.py`), the weights from a seed, and
the program's `roitr_torch.config.Config` with `model="geotransformer"`.

The weights, made on `device` in one draw of a generator seeded with the
run's seed (the same seed, the same weights in either process):
- every Linear's weight and bias and every KPConv's weights and bias:
  uniform in +-1/sqrt(fan_in), fan_in the Linear's input width or the
  KPConv's kernel points times input width (torch's nn.Linear init and
  KPConv's kaiming-uniform bound);
- every GroupNorm and LayerNorm: weight 1, bias 0; the OT dustbin score 1;
- each KPConv's 15 kernel points: KPConv's repulsion disposition with the
  centre fixed, drawn from the seed with numpy (one stream a block), a
  random rotation and noise of 0.01, times the block's radius.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from portbench import synthetic
from portbench.reference import geotransformer as reference

# numpy streams of a seed for the kernel points, one a KPConv in module order
KERNEL_STREAM = 50


def reference_config(values):
    return reference.config(values)


def kernel_points(rng: np.random.RandomState, n: int, iterations: int = 1000,
                  ratio: float = 0.66) -> np.ndarray:
    """(n, 3) points in the unit ball, the first at the centre, spread by
    repulsion (KPConv's kernel_point_optimization_debug, one candidate),
    rescaled to a mean radius of `ratio`, rotated at random, with noise."""
    pts = np.zeros((n, 3))
    i = 1
    while i < n:
        cand = rng.rand(3) * 2 - 1
        if 0.5 < float(np.sum(cand ** 2)) < 0.81:
            pts[i] = cand
            i += 1
    step = 1e-2
    for _ in range(iterations):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = np.sum(diff ** 2, axis=-1)
        grads = np.sum(diff / (d2[..., None] ** 1.5 + 1e-6), axis=1) + 10 * pts
        norms = np.linalg.norm(grads, axis=-1)
        move = np.minimum(step * norms, 0.05)
        move[0] = 0.0
        pts -= (move / (norms + 1e-6))[:, None] * grads
        step *= 0.9995
    pts *= ratio / np.mean(np.linalg.norm(pts[1:], axis=-1))
    theta, phi, alpha = rng.rand() * 2 * np.pi, (rng.rand() - 0.5) * np.pi, rng.rand() * 2 * np.pi
    u = np.array([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
    k = np.array([[0, -u[2], u[1]], [u[2], 0, -u[0]], [-u[1], u[0], 0]])
    rot = np.eye(3) + np.sin(alpha) * k + (1 - np.cos(alpha)) * (k @ k)
    return (pts + rng.normal(scale=0.01, size=pts.shape)) @ rot


def make_state_dict(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = reference.GeoTransformerReference(cfg)
    drawn = []  # (key, shape, bound)
    convs = []
    for name, m in skeleton.named_modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            drawn += [(f"{name}.weight", m.weight.shape, bound), (f"{name}.bias", m.bias.shape,
                                                                  bound)]
        elif isinstance(m, reference.KPConv):
            bound = 1.0 / math.sqrt(m.weights.shape[0] * m.weights.shape[2])
            drawn.append((f"{name}.weights", m.weights.shape, bound))
            if m.bias is not None:
                drawn.append((f"{name}.bias", m.bias.shape, bound))
            convs.append((name, m))
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    ofs = 0
    for key, shape, bound in drawn:
        n = math.prod(shape)
        out[key] = (draw[ofs:ofs + n] * (2 * bound) - bound).reshape(shape)
        ofs += n
    for i, (name, m) in enumerate(convs):
        rng = synthetic.rng_for(seed, KERNEL_STREAM + i)
        pts = kernel_points(rng, m.kernel_points.shape[0]) * m.radius
        out[f"{name}.kernel_points"] = torch.from_numpy(pts.astype(np.float32)).to(device)
    for name, m in skeleton.named_modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            c = m.normalized_shape if isinstance(m, nn.LayerNorm) else (m.num_channels,)
            out[f"{name}.weight"] = torch.ones(c, device=device)
            out[f"{name}.bias"] = torch.zeros(c, device=device)
    out["optimal_transport.alpha"] = torch.tensor(1.0, device=device)
    missing = set(skeleton.state_dict()) - set(out)
    if missing:
        raise RuntimeError(f"weights: no rule for {sorted(missing)}")
    return out


def build_reference(ref_cfg, state_dict, device):
    return reference.build(ref_cfg, state_dict, device)


def program_config(values):
    """The program's Config from the file's values, with model
    "geotransformer". A program whose Config has no `model` field runs no
    GeoTransformer: refuse at once rather than run another model under
    this configuration's name."""
    from roitr_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    if "model" not in fields:
        raise RuntimeError("the program's Config has no `model` field: it cannot build "
                           "GeoTransformer")
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items() if k in fields}
    kw["model"] = "geotransformer"
    return Config(**kw)
