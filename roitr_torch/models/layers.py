"""Linear and LayerNorm layers with a compute dtype.

The JAX package gives every flax `nn.Dense` and `nn.LayerNorm` of the
backbone and the global transformer `dtype=cfg.compute_dtype`, with fp32
parameters. These are their counterparts: the parameters stay fp32 (and
keep nn.Linear's and nn.LayerNorm's state_dict keys), the computation runs
in `dtype`. With the default fp32 they are nn.Linear and nn.LayerNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` from fp32 parameters, as flax's
    nn.Dense(dtype=...): the input, weight and bias are cast to it."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5) whose output is in `dtype`, as flax's
    nn.LayerNorm(dtype=...): statistics and affine map in fp32."""

    def __init__(self, d: int, dtype=torch.float32):
        super().__init__(d, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)
