"""Top-k with a fixed tie order.

The JAX package relies on `lax.top_k`, which orders equal values by lower
index first. `torch.topk` does not promise any order among ties, so every
top-k in the port goes through `topk`: each fp32 value is mapped to an
order-preserving int32, joined with its (possibly reversed) index into one
int64 key, and the keys are unique, so the result does not depend on how
the library breaks ties.
"""

from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def sortable_int(values: torch.Tensor) -> torch.Tensor:
    """fp32 -> int64 whose order is the float total order (-0.0 < +0.0)."""
    bits = values.contiguous().view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)


def topk(values: torch.Tensor, k: int, dim: int = -1, largest: bool = True):
    """(values, indices) of the k largest (or smallest) entries along `dim`,
    sorted, ties broken toward the lower index (lax.top_k's order)."""
    if values.dtype != torch.float32:
        raise TypeError(f"topk takes float32, got {values.dtype}")
    v = values.movedim(dim, -1)
    idx = torch.arange(v.shape[-1], device=v.device, dtype=torch.int64)
    secondary = (_LOW32 - idx) if largest else idx
    key = sortable_int(v) * (1 << 32) + secondary
    _, sel = torch.topk(key, k, dim=-1, largest=largest, sorted=True)
    out = torch.gather(v, -1, sel)
    return out.movedim(-1, dim), sel.movedim(-1, dim)
