"""RoITr's weights from a seed, made on the device in one draw.

Every Linear layer's weight and bias are uniform in +-1/sqrt(fan_in) (the
initialisation of torch's nn.Linear), every LayerNorm has weight 1 and bias
0, and the OT dustbin score is 1. The shapes and names come from the
reference's module tree (the RoITr checkpoint's keys), built on the meta
device; the numbers are one `torch.rand` of a generator on `device` seeded
with the run's seed, so the same seed gives the same weights on the same
card, in either process.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from portbench.reference.model import RoITrReference


def make_state_dict(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        skeleton = RoITrReference(cfg)
    linears = [(name, m) for name, m in skeleton.named_modules() if isinstance(m, nn.Linear)]
    total = sum(m.weight.numel() + m.bias.numel() for _, m in linears)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    ofs = 0
    for name, m in linears:
        bound = 1.0 / math.sqrt(m.in_features)
        for key, p in (("weight", m.weight), ("bias", m.bias)):
            n = p.numel()
            out[f"{name}.{key}"] = (draw[ofs:ofs + n] * (2 * bound) - bound).reshape(p.shape)
            ofs += n
    for name, m in skeleton.named_modules():
        if isinstance(m, nn.LayerNorm):
            out[f"{name}.weight"] = torch.ones(m.normalized_shape, device=device)
            out[f"{name}.bias"] = torch.zeros(m.normalized_shape, device=device)
    out["optimal_transport.alpha"] = torch.tensor(1.0, device=device)
    missing = set(skeleton.state_dict()) - set(out)
    if missing:
        raise RuntimeError(f"weights: no rule for {sorted(missing)}")
    return out
