"""Geometry prep on the device: normals and the backbone's pyramids.

Counterpart of roitr_tpu/ops/pyramid.py. `build_pyramids_packed` builds,
from the padded points alone, the pyramid that data/pyramid.py builds on
the host, for B clouds at once with indices offset into the packed flat
layout (data/packing.py `pack_pyramids` of host pyramids is its twin):

- FPS: all clouds of a level in one kernel launch (kernels/fps_kernel.py);
  `device_prep_packed` runs both sides of B pairs, 2B clouds, together;
- kNN: ops/neighbors.py's exact `masked_knn`, batched over the clouds;
- semantics row for row as on the host: seed-0 FPS over the valid prefix,
  self-excluded kNN with the reference kernel's phantom index-0 padding,
  3-NN inverse-distance upsampling weights (the host edge-pads clouds of
  fewer than 3 keys), and pad rows zero in every field.

`device_prep_pair` and `device_prep_packed` estimate the normals the host
did not and, on request, build both sides' pyramids. A single pair needs
none: without one the backbone builds the same exact pyramid inside its
forward (models/backbone.py), so `device_prep_pair` builds one only when
asked (`pyramid=True`). A packed batch needs them, so `device_prep_packed`
builds them by default.
"""

from __future__ import annotations

import torch

from roitr_torch.data.pyramid import KEY_LEVEL, CloudPyramid
from roitr_torch.ops.fps import furthest_point_sampling
from roitr_torch.ops.neighbors import masked_knn
from roitr_torch.ops.normals import estimate_normals, estimate_normals_segmented


def _row_mask(capacity: int, counts: torch.Tensor) -> torch.Tensor:
    """(C, capacity) bool: row rank < the cloud's valid count."""
    return torch.arange(capacity, device=counts.device)[None, :] < counts[:, None]


def _cloud_pyramids(pts: torch.Tensor, counts: torch.Tensor, strides, nsample) -> dict:
    """Per-cloud pyramid fields of C clouds, (C, rows, ...), indices into
    each cloud's own rows (no offsets)."""
    cur, cur_cnt = pts, counts
    fields = {}
    for lvl, (stride, k) in enumerate(zip(strides, nsample), start=1):
        n = cur.shape[1]
        if stride != 1:
            m = n // stride
            idx = furthest_point_sampling(cur, cur_cnt, m)  # (C, m), one launch
            new_cnt = torch.clamp(cur_cnt // stride, min=1)
            # the host zeroes picks past a cloud's valid sample count
            idx = torch.where(_row_mask(m, new_cnt), idx, torch.zeros_like(idx))
            fields[f"fps_idx{lvl}"] = idx
            new = torch.gather(cur, 1, idx[..., None].expand(-1, -1, 3))

            # decoder 3-NN upsampling: parent queries -> sampled keys. A
            # cloud with fewer valid keys than columns: the host edge-pads
            # with the last valid column's index at distance 1e10, where
            # masked_knn returns pad keys; rewrite those columns
            kk = min(3, m)
            up_i, up_d = masked_knn(cur, new, new_cnt, kk)
            col = torch.arange(kk, device=pts.device)[None, None, :]
            nvalid = new_cnt[:, None, None]
            edge = torch.minimum(col, nvalid - 1).expand(up_i.shape)
            up_i = torch.gather(up_i, -1, edge)
            up_d = torch.where(col >= nvalid, torch.full_like(up_d, 1e10), up_d)
            if kk < 3:
                up_i = torch.cat([up_i, up_i[..., -1:].expand(-1, -1, 3 - kk)], dim=-1)
                up_d = torch.cat([up_d, torch.full_like(up_d[..., :1], 1e10).expand(
                    -1, -1, 3 - kk)], dim=-1)
            recip = 1.0 / torch.clamp(up_d, min=1e-8)
            w = recip / torch.sum(recip, dim=-1, keepdim=True)
            pmask = _row_mask(n, cur_cnt)[..., None]
            fields[f"up_idx{lvl}"] = torch.where(pmask, up_i, torch.zeros_like(up_i))
            fields[f"up_w{lvl}"] = torch.where(pmask, w, torch.zeros_like(w))
        else:
            m, new, new_cnt = n, cur, cur_cnt
        nmask = _row_mask(m, new_cnt)[..., None]
        cross, _ = masked_knn(new, cur, cur_cnt, k, exclude_self=True)
        fields[f"cross_idx{lvl}"] = torch.where(nmask, cross, torch.zeros_like(cross))
        self_i, _ = masked_knn(new, new, new_cnt, k, exclude_self=True)
        fields[f"self_idx{lvl}"] = torch.where(nmask, self_i, torch.zeros_like(self_i))
        cur, cur_cnt = new, new_cnt
    return fields


def _packed(fields: dict) -> CloudPyramid:
    """Per-cloud fields of B clouds -> one packed pyramid: pair b's indices
    offset by b times the capacity of the level they index."""
    out = {}
    for name in CloudPyramid._fields:
        arr = fields[name]
        if not name.startswith("up_w"):
            cap = fields[f"self_idx{KEY_LEVEL[name]}"].shape[1]
            offset = torch.arange(arr.shape[0], device=arr.device) * cap
            arr = arr.long() + offset.reshape(-1, *(1,) * (arr.ndim - 1))
        out[name] = arr.flatten(0, 1)
    return CloudPyramid(**out)


def build_pyramids_packed(points_flat: torch.Tensor, counts: torch.Tensor,
                          strides=(1, 4, 4, 4), nsample=(8, 16, 16, 16)) -> CloudPyramid:
    """B same-bucket clouds packed flat, (B * N, 3) with counts (B,) -> their
    pyramids, packed (data/packing.py `pack_pyramids` of host pyramids)."""
    counts = counts.to(points_flat.device)
    b = counts.shape[0]
    pts = points_flat.reshape(b, -1, 3)
    return _packed(_cloud_pyramids(pts, counts, tuple(strides), tuple(nsample)))


def _both_sides(src_points, src_count, tgt_points, tgt_count, cfg):
    """Packed pyramids of the source and target sides of B pairs, built as
    2B clouds: one FPS launch a level for both sides."""
    b = src_count.shape[0]
    pts = torch.cat([src_points, tgt_points]).reshape(2 * b, -1, 3)
    cnt = torch.cat([src_count, tgt_count]).to(pts.device)
    fields = _cloud_pyramids(pts, cnt, tuple(cfg.enc_strides), tuple(cfg.enc_nsample))
    return (_packed({k: v[:b] for k, v in fields.items()}),
            _packed({k: v[b:] for k, v in fields.items()}))


def device_prep_pair(pair, cfg, est=(True, True), pyramid: bool = False):
    """PairInputs with normals estimated on the device for the sides `est`
    asks for (source, target); the others keep the normals they carry. The
    source side uses the raw source geometry, as the datasets do (reference
    fdmatch.py:85-90, RIGA_v2.py:62). `pyramid=True` also attaches both
    sides' exact pyramids (the backbone builds the same ones otherwise)."""
    k = cfg.normal_knn
    if est[0]:
        pair = pair._replace(src_normals=estimate_normals(pair.src_raw_points, pair.src_count,
                                                          k=k))
    if est[1]:
        pair = pair._replace(tgt_normals=estimate_normals(pair.tgt_points, pair.tgt_count, k=k))
    if not pyramid:
        return pair
    src, tgt = _both_sides(pair.src_raw_points, pair.src_count.reshape(1), pair.tgt_points,
                           pair.tgt_count.reshape(1), cfg)
    return pair._replace(src_pyramid=src, tgt_pyramid=tgt)


def device_prep_packed(pair, cfg, est=(True, True), pyramid: bool = True):
    """device_prep_pair for a packed flat batch ((B * N, ...) leaves, (B,)
    counts): segmented normals, and both sides' pyramids built together,
    indices offset into the flat layout."""
    k = cfg.normal_knn
    if est[0]:
        pair = pair._replace(src_normals=estimate_normals_segmented(
            pair.src_raw_points, pair.src_count, k=k))
    if est[1]:
        pair = pair._replace(tgt_normals=estimate_normals_segmented(
            pair.tgt_points, pair.tgt_count, k=k))
    if not pyramid:
        return pair
    src, tgt = _both_sides(pair.src_raw_points, pair.src_count, pair.tgt_points,
                           pair.tgt_count, cfg)
    return pair._replace(src_pyramid=src, tgt_pyramid=tgt)
