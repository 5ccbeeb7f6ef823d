"""One host-to-device copy for a batch's inputs.

Counterpart of roitr_tpu/utils/packing.py (`build_spec`, `pack_host`,
`unpack_device`): the tensors of a nested structure of NamedTuples, tuples
and lists (PairInputs with its pyramids, a list of them) are written into
one pinned fp32 host buffer, copied to the card in one transfer, and taken
apart there as views. Int leaves travel as int32 bit patterns in the fp32
carrier (and widen back to their dtype on the card), bools as 0.0 / 1.0.
`None` leaves stay None. The spec is fixed by the shapes, so one spec
serves every batch of a bucket.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

# (shape, dtype, offset, size) of each tensor leaf, in flattening order
Spec = List[Tuple[tuple, torch.dtype, int, int]]
_INT_DTYPES = (torch.int32, torch.int64)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [torch.as_tensor(tree)]


def _rebuild(tree, leaves):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        parts = [_rebuild(t, leaves) for t in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*parts)
        return type(tree)(parts)
    return next(leaves)


def build_spec(tree) -> Tuple[Spec, int]:
    """(spec, total fp32 elements) of the tree's tensor leaves."""
    spec, ofs = [], 0
    for a in _leaves(tree):
        if a.dtype not in (torch.float32, torch.bool, *_INT_DTYPES):
            raise TypeError(f"unsupported leaf dtype {a.dtype}")
        spec.append((tuple(a.shape), a.dtype, ofs, a.numel()))
        ofs += a.numel()
    return spec, ofs


def pack_host(tree, spec: Spec, total: int, pin: bool = True) -> torch.Tensor:
    """The tree's leaves in one contiguous fp32 host buffer (pinned)."""
    out = torch.empty((total,), dtype=torch.float32, pin_memory=pin)
    for a, (_, dtype, ofs, n) in zip(_leaves(tree), spec):
        flat = a.detach().cpu().reshape(-1)
        if dtype in _INT_DTYPES:
            flat = flat.to(torch.int32).view(torch.float32)
        elif dtype == torch.bool:
            flat = flat.to(torch.float32)
        out[ofs:ofs + n] = flat
    return out


def unpack_device(packed: torch.Tensor, tree, spec: Spec):
    """Inverse of pack_host on the device the buffer lies on: slices and
    bit views of `packed`, int leaves widened back to their dtype. `tree`
    gives the structure (its leaves' values are not read)."""
    parts = []
    for shape, dtype, ofs, n in spec:
        seg = packed[ofs:ofs + n]
        if dtype in _INT_DTYPES:
            seg = seg.view(torch.int32).to(dtype)
        elif dtype == torch.bool:
            seg = seg != 0.0
        parts.append(seg.reshape(shape))
    return _rebuild(tree, iter(parts))


def to_device(tree, device) -> Any:
    """The tree on `device` through one pinned buffer and one non-blocking
    copy (on a CPU device, the tree as it is)."""
    device = torch.device(device)
    if device.type == "cpu":
        return tree
    spec, total = build_spec(tree)
    host = pack_host(tree, spec, total)
    return unpack_device(host.to(device, non_blocking=True), tree, spec)

