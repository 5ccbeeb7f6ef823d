"""Name -> layer registries (reference model/transformer/factory.py:7-66).

Counterpart of roitr_tpu/utils/factory.py: configs select activation,
normalisation and dropout variants by name; here each name builds a torch
module that computes what the JAX package's flax function or module of
that name computes (GELU is flax's tanh approximation; GroupNorm takes
channels last, 8 groups, eps 1e-6, as flax's).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

ACT_LAYERS = {
    "ReLU": nn.ReLU,
    "LeakyReLU": lambda: nn.LeakyReLU(negative_slope=0.2),
    "ELU": nn.ELU,
    "GELU": lambda: nn.GELU(approximate="tanh"),
    "Sigmoid": nn.Sigmoid,
    "Softplus": nn.Softplus,
    "Tanh": nn.Tanh,
    "Identity": nn.Identity,
}


class GroupNorm(nn.GroupNorm):
    """flax's nn.GroupNorm(num_groups=8): channels on the last axis,
    statistics over each group's channels and every axis but the first."""

    def __init__(self, dim: int, num_groups: int = 8):
        super().__init__(num_groups, dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(-1, 1)).movedim(1, -1)


NORM_LAYERS = {
    "LayerNorm": lambda dim: nn.LayerNorm(dim, eps=1e-5),
    "GroupNorm": GroupNorm,
    "None": lambda dim: nn.Identity(),
}


def build_act_layer(name: Optional[str]) -> nn.Module:
    """Reference factory.py build_act_layer; None -> identity."""
    if name is None:
        return nn.Identity()
    if name not in ACT_LAYERS:
        raise ValueError(f"unknown activation {name!r}")
    return ACT_LAYERS[name]()


def build_dropout_layer(p: Optional[float]) -> nn.Module:
    """Reference factory.py build_dropout_layer: None or 0 -> identity, else
    nn.Dropout(p), active in train mode only (the reference trains with
    dropout None throughout)."""
    if p is None or p == 0.0:
        return nn.Identity()
    return nn.Dropout(p)


def build_norm_layer(name: str, dim: int) -> nn.Module:
    if name not in NORM_LAYERS:
        raise ValueError(f"unknown norm {name!r}")
    return NORM_LAYERS[name](dim)
