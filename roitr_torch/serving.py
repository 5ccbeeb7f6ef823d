"""One-call correspondence inference on raw point clouds.

Counterpart of roitr_tpu/serving.py `Matcher`: host preprocessing (normal
estimation + view-point redirect + bucket padding, and with
`cfg.host_pyramid` the FPS/kNN pyramids), the pipeline on the device, and
the fixed-capacity outputs trimmed back to ragged numpy.

    matcher = Matcher(cfg, state_dict)          # device="cuda" by default
    matcher = Matcher.from_checkpoint("model_best_loss.pth", cfg)
    out = matcher.match(src_xyz, tgt_xyz)       # (n, 3) float numpy each
    out["src_corr_pts"], out["tgt_corr_pts"], out["confidence"]
    outs = matcher.match_batch([(src, tgt), ...], batch_size=8)

Normals are estimated as the datasets do (kNN-33 PCA + view-point
redirect, reference dataset/tdmatch.py:120-127), on the host with
`prep="host"` (the default) or on the device with `prep="device"`
(ops/normals.py); pass `src_normals` / `tgt_normals` to skip that.
`match_batch` runs many pairs, same-bucket pairs packed into one forward
(data/packing.py) or one after another.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from roitr_torch.config import Config
from roitr_torch.data.packing import pack_pairs
from roitr_torch.data.preprocess import (
    estimate_normals_np,
    normal_redirect_np,
    pad_cloud,
    pick_bucket,
)
from roitr_torch.data.pyramid import build_cloud_pyramid, pyramid_to_torch
from roitr_torch.models.roitr import PairInputs, RoITr
from roitr_torch.ops.pyramid import device_prep_packed, device_prep_pair
from roitr_torch.train.checkpoint import load_model_state
from roitr_torch.utils.packing import to_device

# correspondence rows copied to the host: src xyz 0:3 | tgt xyz 3:6 |
# score 6 | mask 7, one (..., C, 8) array a forward (one copy, not four)


def _corr_pack(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([out["src_corr_points"], out["tgt_corr_points"],
                      out["corr_scores"][..., None],
                      out["corr_masks"].to(torch.float32)[..., None]], dim=-1)


def _corr_unpack(corr: np.ndarray) -> Dict[str, np.ndarray]:
    """One pair's (C, 8) rows -> the trimmed result dict of `match`."""
    keep = corr[:, 7] > 0.5
    return {"src_corr_pts": corr[keep, 0:3], "tgt_corr_pts": corr[keep, 3:6],
            "confidence": corr[keep, 6]}


class Matcher:
    """Serving wrapper around the RoITr pipeline."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor], device="cuda",
                 descriptors: bool = False, prep: str = "host"):
        """prep: where the normals the caller does not give are estimated,
        "host" (scipy kNN + PCA, data/preprocess.py) or "device" (exact kNN
        + closed-form PCA on the device, ops/normals.py). Normals the caller
        gives are always used. With `cfg.host_pyramid` and prep="host",
        each pair's FPS/kNN pyramids are built on the host (data/pyramid.py)
        and the forward runs no search; under prep="device" the device
        builds them (a packed batch) or the backbone does (one pair)."""
        if prep not in ("host", "device"):
            raise ValueError(f"unknown prep mode {prep!r}")
        self.cfg = cfg
        self.descriptors = descriptors
        self.prep = prep
        self.model = RoITr(cfg, device=device)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self.device = self.model.device

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Config, device="cuda", **kw) -> "Matcher":
        """A Matcher with the weights of a port checkpoint, a reference
        RoITr `.pth` or a bare state_dict (train/checkpoint.py
        `load_model_state`)."""
        return cls(cfg, load_model_state(path), device=device, **kw)

    def _cap(self, src_pcd, tgt_pcd, src_normals, tgt_normals):
        """Cap each cloud to the dataset limit and the largest bucket by a
        random subset (reference dataset/tdmatch.py:72-78); given normals
        follow the same permutation."""
        src_pcd = np.ascontiguousarray(src_pcd, np.float32)
        tgt_pcd = np.ascontiguousarray(tgt_pcd, np.float32)
        limit = min(self.cfg.points_limit, max(self.cfg.buckets))
        if len(src_pcd) > limit or len(tgt_pcd) > limit:
            rng = np.random.RandomState(0)
            if len(src_pcd) > limit:
                idx = rng.permutation(len(src_pcd))[:limit]
                src_pcd = src_pcd[idx]
                if src_normals is not None:
                    src_normals = np.asarray(src_normals, np.float32)[idx]
            if len(tgt_pcd) > limit:
                idx = rng.permutation(len(tgt_pcd))[:limit]
                tgt_pcd = tgt_pcd[idx]
                if tgt_normals is not None:
                    tgt_normals = np.asarray(tgt_normals, np.float32)[idx]
        return src_pcd, tgt_pcd, src_normals, tgt_normals

    def _prepare(self, src_pcd, tgt_pcd, src_normals, tgt_normals):
        """(PairInputs on the host, est): est says which sides' normals are
        still to be estimated on the device; those carry zeros until then."""
        cfg = self.cfg
        src_pcd, tgt_pcd, src_normals, tgt_normals = self._cap(src_pcd, tgt_pcd, src_normals,
                                                               tgt_normals)
        view = np.zeros(3, np.float32)  # datasets redirect toward the origin
        est = (src_normals is None and self.prep == "device",
               tgt_normals is None and self.prep == "device")
        if src_normals is None:
            src_normals = (np.zeros_like(src_pcd) if est[0] else normal_redirect_np(
                src_pcd, estimate_normals_np(src_pcd, cfg.normal_knn), view))
        if tgt_normals is None:
            tgt_normals = (np.zeros_like(tgt_pcd) if est[1] else normal_redirect_np(
                tgt_pcd, estimate_normals_np(tgt_pcd, cfg.normal_knn), view))
        bucket = pick_bucket(max(len(src_pcd), len(tgt_pcd)), cfg.buckets)
        s_pts, s_nrm, s_feats, s_cnt = pad_cloud(src_pcd, src_normals, bucket)
        t_pts, t_nrm, t_feats, t_cnt = pad_cloud(tgt_pcd, tgt_normals, bucket)
        pyramids = {}
        if cfg.host_pyramid and self.prep == "host":
            build = lambda pts, cnt: pyramid_to_torch(build_cloud_pyramid(
                pts, cnt, strides=tuple(cfg.enc_strides), nsample=tuple(cfg.enc_nsample)))
            pyramids = dict(src_pyramid=build(s_pts, s_cnt), tgt_pyramid=build(t_pts, t_cnt))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        count = lambda c: torch.tensor(int(c), dtype=torch.int64)
        src = t(s_pts)
        pair = PairInputs(src_points=src, src_raw_points=src, src_normals=t(s_nrm),
                          src_feats=t(s_feats), src_count=count(s_cnt), tgt_points=t(t_pts),
                          tgt_normals=t(t_nrm), tgt_feats=t(t_feats), tgt_count=count(t_cnt),
                          **pyramids)
        return pair, est

    @torch.no_grad()
    def match(self, src_pcd: np.ndarray, tgt_pcd: np.ndarray,
              src_normals: Optional[np.ndarray] = None,
              tgt_normals: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Dense correspondences between two raw clouds.

        Returns src_corr_pts/tgt_corr_pts (C, 3) and confidence (C,), C
        data-dependent; with descriptors=True also the node and point
        descriptors, trimmed to the valid counts."""
        pair, est = self._prepare(src_pcd, tgt_pcd, src_normals, tgt_normals)
        out = self.model(device_prep_pair(to_device(pair, self.device), self.cfg, est))
        res = _corr_unpack(_corr_pack(out).cpu().numpy())
        if self.descriptors:
            sc, tc = int(out["src_count"]), int(out["tgt_count"])
            snc, tnc = int(out["src_node_count"]), int(out["tgt_node_count"])
            res.update(
                src_nodes=out["src_nodes"][:snc].cpu().numpy(),
                tgt_nodes=out["tgt_nodes"][:tnc].cpu().numpy(),
                src_node_desc=out["src_node_feats"][:snc].cpu().numpy(),
                tgt_node_desc=out["tgt_node_feats"][:tnc].cpu().numpy(),
                src_point_desc=out["src_point_feats"][:sc].cpu().numpy(),
                tgt_point_desc=out["tgt_point_feats"][:tc].cpu().numpy(),
            )
        return res

    def _run_group(self, group: List[PairInputs], mode: str, est) -> torch.Tensor:
        """One group's forward(s) on the device -> (B, C, 8) correspondence
        rows. packed: the group as one packed pair (pyramids built on the
        device under prep="device"); map: the pairs one after another
        through the single-pair forward. The group's inputs go to the card
        in one copy."""
        if mode == "packed":
            batch = to_device(pack_pairs(group, require_pyramids=self.prep != "device"),
                              self.device)
            batch = device_prep_packed(batch, self.cfg, est, pyramid=batch.src_pyramid is None)
            return _corr_pack(self.model(batch))
        pairs = to_device(group, self.device)
        return torch.stack([_corr_pack(self.model(device_prep_pair(p, self.cfg, est)))
                            for p in pairs])

    @torch.no_grad()
    def match_batch(self, pairs: Sequence, batch_size: int = 8,
                    mode: str = "auto") -> List[Dict[str, np.ndarray]]:
        """Correspondences of many pairs, batched (roitr_tpu/serving.py
        `match_batch`). `pairs`: (src, tgt) or (src, tgt, src_normals,
        tgt_normals) tuples of raw clouds.

        Pairs are grouped by bucket and by which normals the device
        estimates; each group runs in batches of up to `batch_size`:
        - "packed": a batch as one packed forward (data/packing.py), one
          launch of each forward kernel a layer for the whole batch;
        - "map": the batch's pairs one after another through the
          single-pair forward;
        - "auto": packed at buckets <= 1024, map above.
        A ragged tail runs as a smaller batch: the forward takes any batch
        size, and an eager forward has no compiled program per size to
        reuse, so padding it would only add forwards. At most three batches
        are in flight: each one's rows are copied into pinned
        host memory behind an event, and batches are read in order.
        Requires cfg.host_pyramid under prep="host" (a packed batch needs
        pyramids; under prep="device" the device builds them).

        Returns one dict a pair, in input order, with the keys of `match`
        without descriptors."""
        if mode not in ("auto", "packed", "map"):
            raise ValueError(f"unknown match_batch mode {mode!r}")
        if not self.cfg.host_pyramid and self.prep != "device":
            raise ValueError("match_batch requires cfg.host_pyramid=True or prep='device'")
        prepared, groups = [], {}
        for i, item in enumerate(pairs):
            pair, est = self._prepare(item[0], item[1], item[2] if len(item) > 2 else None,
                                      item[3] if len(item) > 3 else None)
            prepared.append(pair)
            groups.setdefault((int(pair.src_points.shape[0]), est), []).append(i)

        window = 3
        results: Dict[int, Dict[str, np.ndarray]] = {}
        inflight: list = []  # (pair indices, pinned rows, event)

        def drain_one():
            idxs, host, event = inflight.pop(0)
            if event is not None:
                event.synchronize()
            corr = host.numpy()
            for j, i in enumerate(idxs):
                results[i] = _corr_unpack(corr[j])

        for (bucket, est), idxs in groups.items():
            use_mode = mode if mode != "auto" else ("packed" if bucket <= 1024 else "map")
            for s in range(0, len(idxs), batch_size):
                group = idxs[s:s + batch_size]
                rows = self._run_group([prepared[i] for i in group], use_mode, est)
                event = None
                if rows.is_cuda:
                    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    host = rows
                inflight.append((group, host, event))
                if len(inflight) > window:
                    drain_one()
        while inflight:
            drain_one()
        return [results[i] for i in range(len(prepared))]
