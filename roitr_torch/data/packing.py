"""Packing of B same-bucket pairs into one flat "packed batch".

Counterpart of roitr_tpu/data/packing.py. B pairs become one flat cloud of
B * N rows a side: every per-point op runs unchanged on the flat arrays,
every neighbourhood gather stays a plain row gather because the pyramids'
indices are offset per segment, and segment b of a level with per-pair
capacity m occupies rows [b * m, (b + 1) * m), so a (B, m, ...) view is a
free reshape (models/roitr.py `_forward_packed`). A packed batch needs
pyramids: attached on the host (`attach_pyramids`, data/pyramid.py) or
built on the device after packing (ops/pyramid.py `device_prep_packed`).
Leaves are torch tensors; the packed pair lies where its pairs lie.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from roitr_torch.data.pyramid import KEY_LEVEL, CloudPyramid, build_cloud_pyramid, \
    pyramid_to_torch


def pack_pyramids(pyramids: Sequence[CloudPyramid]) -> CloudPyramid:
    """Concatenate per-pair pyramids (numpy or tensors), each pair's indices
    offset by b times the capacity of the level they index (KEY_LEVEL);
    weights concatenate unchanged. Indices come back int64, weights fp32."""
    sizes = {lvl: int(getattr(pyramids[0], f"self_idx{lvl}").shape[0]) for lvl in (1, 2, 3, 4)}
    fields = {}
    for name in CloudPyramid._fields:
        arrs = [torch.as_tensor(getattr(p, name)) for p in pyramids]
        if name.startswith("up_w"):
            fields[name] = torch.cat([a.to(torch.float32) for a in arrs])
        else:
            ks = sizes[KEY_LEVEL[name]]
            fields[name] = torch.cat([a.to(torch.int64) + b * ks for b, a in enumerate(arrs)])
    return CloudPyramid(**fields)


def pack_pairs(pairs: Sequence, require_pyramids: bool = True):
    """Pack B same-bucket PairInputs into one packed PairInputs: point
    leaves concatenated to (B * N, ...), counts stacked to (B,), rot and
    trans to (B, ...), pyramids packed with offset indices. Every pair must
    carry both pyramids, unless `require_pyramids=False` (the device builds
    them after packing, ops/pyramid.py); then the packed pyramids are None.
    The packed forward takes each side's segment size as its rows over B,
    so the sources and targets of all pairs must share one bucket."""
    from roitr_torch.models.roitr import PairInputs

    buckets = {int(p.src_points.shape[0]) for p in pairs} | \
        {int(p.tgt_points.shape[0]) for p in pairs}
    if len(buckets) != 1:
        raise ValueError(f"packed batch needs one shared src/tgt bucket, got {sorted(buckets)}")
    has_pyramids = all(p.src_pyramid is not None and p.tgt_pyramid is not None for p in pairs)
    if require_pyramids and not has_pyramids:
        raise ValueError("packed batches require host pyramids on every pair (build them, or "
                         "pass require_pyramids=False for device-side pyramid construction)")
    cat = lambda name: torch.cat([getattr(p, name) for p in pairs])
    stack = lambda name: (None if getattr(pairs[0], name) is None
                          else torch.stack([getattr(p, name) for p in pairs]))
    return PairInputs(
        src_points=cat("src_points"), src_raw_points=cat("src_raw_points"),
        src_normals=cat("src_normals"), src_feats=cat("src_feats"),
        src_count=stack("src_count"), tgt_points=cat("tgt_points"),
        tgt_normals=cat("tgt_normals"), tgt_feats=cat("tgt_feats"),
        tgt_count=stack("tgt_count"), rot=stack("rot"), trans=stack("trans"),
        src_pyramid=pack_pyramids([p.src_pyramid for p in pairs]) if has_pyramids else None,
        tgt_pyramid=pack_pyramids([p.tgt_pyramid for p in pairs]) if has_pyramids else None)


def attach_pyramids(pair, strides, nsample):
    """Build both clouds' host pyramids of one pair and attach them as
    tensors on the pair's device (no-op when both are there). The source
    side is built on the raw source geometry, as the datasets do."""
    if pair.src_pyramid is not None and pair.tgt_pyramid is not None:
        return pair
    build = lambda pts, cnt: pyramid_to_torch(build_cloud_pyramid(
        np.asarray(pts.cpu()), int(cnt), strides=tuple(strides), nsample=tuple(nsample)),
        pts.device)
    return pair._replace(src_pyramid=build(pair.src_raw_points, pair.src_count),
                         tgt_pyramid=build(pair.tgt_points, pair.tgt_count))
