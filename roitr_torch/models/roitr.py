"""The RoITr coarse-to-fine matching pipeline, one pair or a packed batch.

Counterpart of roitr_tpu/models/roitr.py (reference model/RIGA_v2.py:10-180):
backbone -> descriptor projections -> point-to-node partition -> GT patch
correspondences (`with_gt`) -> coarse matching -> patch gathering ->
Sinkhorn OT -> fine matching, with fixed-size buffers and masks wherever
the reference is ragged. Outputs carry the JAX forward's keys. Training
(`train=True`) takes sampled GT patches and a differentiable OT. A packed
batch of B pairs (data/packing.py) runs as one forward whose outputs carry
a leading B (`_forward_packed`), in training too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from roitr_torch.config import Config
from roitr_torch.models.backbone import RIPointTransformer
from roitr_torch.models.matching import (
    CoarseCorr,
    adaptive_superpoint_matching,
    coarse_matching,
    fine_matching,
    gt_coarse_corr_generator,
)
from roitr_torch.ops.partition import (
    NodeCorrespondences,
    node_correspondences,
    node_occlusion_score,
    point_to_node_partition,
)
from roitr_torch.ops.neighbors import check_knn_method
from roitr_torch.ops.sinkhorn import SINKHORN_BACKENDS, log_sinkhorn_ot


class PairInputs(NamedTuple):
    """One padded point-cloud pair (prefix-packed), torch tensors.

    For rigid benchmarks src_points == src_raw_points; for 4DMatch
    src_points is the deformed source (the matching geometry) and
    src_raw_points the raw one, on which the backbone runs (reference
    RIGA_v2.py:58-62). A packed batch (data/packing.py) has (B * N, ...)
    point leaves, (B,) counts and a leading B on rot and trans."""

    src_points: torch.Tensor  # (N, 3)
    src_raw_points: torch.Tensor  # (N, 3)
    src_normals: torch.Tensor  # (N, 3)
    src_feats: torch.Tensor  # (N, 1)
    src_count: torch.Tensor  # () int64
    tgt_points: torch.Tensor  # (N, 3)
    tgt_normals: torch.Tensor  # (N, 3)
    tgt_feats: torch.Tensor  # (N, 1)
    tgt_count: torch.Tensor  # () int64
    rot: Optional[torch.Tensor] = None  # (3, 3) GT rotation src -> tgt, with_gt only
    trans: Optional[torch.Tensor] = None  # (3, 1) GT translation, with_gt only
    # geometric pyramids (data/pyramid.py CloudPyramid of tensors on the
    # pair's device), or None: the backbone then runs FPS and kNN itself
    src_pyramid: Optional[Any] = None
    tgt_pyramid: Optional[Any] = None


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA device must exist (no
    silent fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for but no CUDA device is available; "
                               "pass device='cpu' to run the plain versions on the CPU")
        # full fp32 products (x^2 - 2xy + y^2 distances, descriptors)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: Linear weights and biases U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), LayerNorm weight 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            with torch.no_grad():
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * bound - bound)
                m.bias.copy_(torch.rand(m.bias.shape, generator=generator) * 2 * bound - bound)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LearnableLogOptimalTransport(nn.Module):
    """Holds the learnable dustbin score (reference modules.py:10-72)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(1.0))


class RoITr(nn.Module):
    """The matching pipeline. `state_dict()` has the reference checkpoint's
    key layout less the entries the model never reads."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0):
        super().__init__()
        # cfg.device_prep, host_pyramid and packed_batch are read by the
        # callers (datasets, Tester, Matcher), which attach pyramids, pack
        # pairs and run ops/pyramid.py's device prep before the forward
        check_knn_method(cfg.knn_method)
        if cfg.sinkhorn_backend not in SINKHORN_BACKENDS:
            raise ValueError(f"sinkhorn_backend must be one of {SINKHORN_BACKENDS}, got "
                             f"{cfg.sinkhorn_backend!r}")
        if cfg.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, got "
                             f"{cfg.compute_dtype!r}")
        device = resolve_device(device)
        self.cfg = cfg
        f = cfg.channel_factor
        self.backbone = RIPointTransformer(
            transformer_blocks=tuple(cfg.transformer_architecture), factor=f,
            num_heads=cfg.num_heads, enc_blocks=tuple(cfg.enc_blocks),
            strides=tuple(cfg.enc_strides), nsample=tuple(cfg.enc_nsample),
            geo_embedding_storage=cfg.geo_embedding_storage,
            dtype=_COMPUTE_DTYPES[cfg.compute_dtype], remat_local=cfg.remat_local)
        self.coarse_proj = nn.Linear(256 * f, 256 * f)
        self.fine_proj = nn.Linear(64 * f, 256 * f)
        self.optimal_transport = LearnableLogOptimalTransport()
        init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)
        self.device = device

    def forward(self, pair: PairInputs, train: bool = False, with_gt: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One pair -> the JAX forward's output dict. `with_gt` adds the GT
        node correspondences and occlusion scores (needs pair.rot/trans);
        `train` (needs with_gt) samples GT patches with the Gumbel noise of
        the CPU `generator`. Gradients flow as in JAX: not into coarse or
        fine matching. Callers that want no graph run under torch.no_grad.
        A packed pair (counts of shape (B,), data/packing.py) goes through
        `_forward_packed`."""
        if train and not with_gt:
            raise ValueError("training requires with_gt=True")
        if with_gt and (pair.rot is None or pair.trans is None):
            raise ValueError("with_gt=True needs pair.rot and pair.trans")
        if pair.src_count.ndim == 1:
            return self._forward_packed(pair, train=train, with_gt=with_gt, generator=generator)
        out = self._backbone_outputs(pair)
        stage = self._pair_stage(out, pair.rot, pair.trans, train, with_gt, generator)
        out.update(stage.outputs)
        out.update(self._ot_and_fine(stage, train))
        return out

    def _backbone_outputs(self, pair: PairInputs) -> Dict[str, torch.Tensor]:
        """Backbone and descriptor projections (reference RIGA_v2.py:58-80);
        flat (B * N, ...) rows for a packed pair. The projections are fp32
        whatever the compute dtype (JAX's flax Dense without a dtype
        promotes bf16 x fp32 to fp32)."""
        (src_nodes, src_node_feats, src_points, src_point_feats, src_node_count, tgt_nodes,
         tgt_node_feats, tgt_points, tgt_point_feats, tgt_node_count) = self.backbone(
            pair.src_raw_points, pair.src_normals, pair.src_feats, pair.src_count,
            pair.tgt_points, pair.tgt_normals, pair.tgt_feats, pair.tgt_count, pair.src_points,
            src_pyramid=pair.src_pyramid, tgt_pyramid=pair.tgt_pyramid)
        return {
            "src_points": src_points, "tgt_points": tgt_points,
            "src_nodes": src_nodes, "tgt_nodes": tgt_nodes,
            "src_point_feats": self.fine_proj(src_point_feats.float()),
            "tgt_point_feats": self.fine_proj(tgt_point_feats.float()),
            "src_node_feats": F.normalize(self.coarse_proj(src_node_feats.float()), dim=-1,
                                          eps=1e-12),
            "tgt_node_feats": F.normalize(self.coarse_proj(tgt_node_feats.float()), dim=-1,
                                          eps=1e-12),
            "src_count": pair.src_count, "tgt_count": pair.tgt_count,
            "src_node_count": src_node_count, "tgt_node_count": tgt_node_count,
        }

    def _pair_stage(self, out, rot, trans, train: bool, with_gt: bool,
                    generator: Optional[torch.Generator]) -> "_Stage":
        """One pair from the backbone's outputs to its patches: partition, GT
        node correspondences and occlusion, coarse matching, and the
        per-correspondence patches the OT reads."""
        cfg = self.cfg
        src_points, tgt_points = out["src_points"], out["tgt_points"]
        src_nodes, tgt_nodes = out["src_nodes"], out["tgt_nodes"]
        src_node_count, tgt_node_count = out["src_node_count"], out["tgt_node_count"]
        src_count, tgt_count = out["src_count"], out["tgt_count"]
        res: Dict[str, torch.Tensor] = {}

        # point-to-node partition (reference RIGA_v2.py:82-89)
        src_part = point_to_node_partition(src_points, src_nodes, cfg.point_per_patch,
                                           src_count, src_node_count)
        tgt_part = point_to_node_partition(tgt_points, tgt_nodes, cfg.point_per_patch,
                                           tgt_count, tgt_node_count)
        zrow = src_points.new_zeros((1, 3))
        src_padded_points = torch.cat([src_points, zrow])
        tgt_padded_points = torch.cat([tgt_points, zrow])
        src_node_knn_points = src_padded_points[src_part.node_knn_indices]
        tgt_node_knn_points = tgt_padded_points[tgt_part.node_knn_indices]

        # GT node correspondences and occlusion (reference RIGA_v2.py:91-116);
        # empty in serving mode
        dev = src_points.device
        if with_gt:
            gt_corr = node_correspondences(
                tgt_nodes, src_nodes, tgt_node_knn_points, src_node_knn_points, rot,
                trans, cfg.matching_radius, ref_masks=tgt_part.node_masks,
                src_masks=src_part.node_masks, ref_knn_masks=tgt_part.node_knn_masks,
                src_knn_masks=src_part.node_knn_masks, max_candidates=cfg.max_gt_corr_candidates)
            gt_tgt_occ, gt_src_occ = node_occlusion_score(
                tgt_part.node_knn_indices, src_part.node_knn_indices, tgt_padded_points,
                src_padded_points, tgt_count, src_count, rot, trans,
                ref_masks=tgt_part.node_masks, src_masks=src_part.node_masks,
                ref_knn_masks=tgt_part.node_knn_masks, src_knn_masks=src_part.node_knn_masks)
        else:
            c = min(cfg.max_gt_corr_candidates, tgt_nodes.shape[0] * src_nodes.shape[0])
            gt_corr = NodeCorrespondences(
                torch.zeros((c, 2), dtype=torch.int64, device=dev),
                torch.zeros((c,), dtype=torch.float32, device=dev),
                torch.zeros((c,), dtype=torch.bool, device=dev))
            gt_tgt_occ = torch.zeros((tgt_nodes.shape[0],), device=dev)
            gt_src_occ = torch.zeros((src_nodes.shape[0],), device=dev)
        res["gt_node_corr_indices"] = gt_corr.indices
        res["gt_node_corr_overlaps"] = gt_corr.overlaps
        res["gt_node_corr_masks"] = gt_corr.masks
        res["gt_tgt_node_occ"] = gt_tgt_occ
        res["gt_src_node_occ"] = gt_src_occ

        # coarse matching, no gradient (reference RIGA_v2.py:119-126, no_grad):
        # the top-k of rigid benchmarks, the adaptive threshold of non-rigid
        # ones, whose buffer holds `capacity` correspondences
        tgt_f, src_f = out["tgt_node_feats"].detach(), out["src_node_feats"].detach()
        if cfg.is_rigid:
            est = coarse_matching(tgt_f, src_f, tgt_part.node_masks, src_part.node_masks,
                                  cfg.num_est_coarse_corr, dual_normalization=True)
        else:
            m = adaptive_superpoint_matching(
                src_f, tgt_f, src_part.node_masks, tgt_part.node_masks,
                min_num_correspondences=cfg.num_est_coarse_corr,
                capacity=cfg.coarse_corr_capacity or max(4 * cfg.num_est_coarse_corr, 512),
                similarity_threshold=cfg.coarse_similarity_threshold)
            # it returns (src, tgt); the pipeline reads (tgt = ref, src)
            est = CoarseCorr(m.src_indices, m.ref_indices, m.scores, m.masks)
        res["tgt_node_corr_indices"] = est.ref_indices
        res["src_node_corr_indices"] = est.src_indices
        res["node_corr_masks"] = est.masks
        if train:  # sampled GT patches (reference RIGA_v2.py:125-126)
            corr = gt_coarse_corr_generator(gt_corr.indices, gt_corr.overlaps, gt_corr.masks,
                                            cfg.num_gt_coarse_corr,
                                            cfg.coarse_overlap_threshold, generator=generator)
        else:
            corr = est

        # per-correspondence patches (reference :129-147)
        tgt_idx, src_idx = corr.ref_indices, corr.src_indices
        src_knn_idx = src_part.node_knn_indices[src_idx]  # (P, K)
        tgt_knn_idx = tgt_part.node_knn_indices[tgt_idx]
        res["src_node_corr_knn_points"] = src_node_knn_points[src_idx]  # (P, K, 3)
        res["tgt_node_corr_knn_points"] = tgt_node_knn_points[tgt_idx]
        res["src_node_corr_knn_masks"] = src_part.node_knn_masks[src_idx] & corr.masks[:, None]
        res["tgt_node_corr_knn_masks"] = tgt_part.node_knn_masks[tgt_idx] & corr.masks[:, None]
        src_point_feats, tgt_point_feats = out["src_point_feats"], out["tgt_point_feats"]
        zfeat = src_point_feats.new_zeros((1, src_point_feats.shape[-1]))
        src_knn_feats = torch.cat([src_point_feats, zfeat])[src_knn_idx]  # (P, K, C)
        tgt_knn_feats = torch.cat([tgt_point_feats, zfeat])[tgt_knn_idx]
        return _Stage(res, src_knn_feats, tgt_knn_feats, corr.masks, corr.scores)

    def _ot_and_fine(self, stage: "_Stage", train: bool) -> Dict[str, torch.Tensor]:
        """Patch OT and fine matching over the stage's P patches (all B * P
        of a packed batch at once: one Sinkhorn launch)."""
        cfg = self.cfg
        o = stage.outputs
        tgt_knn_points, src_knn_points = o["tgt_node_corr_knn_points"], o["src_node_corr_knn_points"]
        tgt_knn_masks, src_knn_masks = o["tgt_node_corr_knn_masks"], o["src_node_corr_knn_masks"]
        # optimal transport (reference :150-153); rows: tgt, cols: src. The
        # convergence exit is for inference only: training keeps the
        # reference's fixed count, as JAX's does
        ch = stage.src_knn_feats.shape[-1]
        matching_scores = torch.einsum("pnc,pmc->pnm", stage.tgt_knn_feats,
                                       stage.src_knn_feats) / ch ** 0.5
        matching_scores = log_sinkhorn_ot(
            matching_scores, tgt_knn_masks, src_knn_masks, self.optimal_transport.alpha,
            num_iter=cfg.sinkhorn_iters, tol=0.0 if train else cfg.sinkhorn_tol,
            differentiable=train, backend=cfg.sinkhorn_backend)

        # fine matching (reference :158-169), no gradient; the exact path in
        # training, as the JAX train step takes it
        scores = matching_scores.detach()
        if not cfg.fine_matching_use_dustbin:
            scores = scores[:, :-1, :-1]
        fine = fine_matching(
            tgt_knn_points, src_knn_points, tgt_knn_masks, src_knn_masks, scores,
            stage.corr_masks, global_scores=stage.corr_scores, k=cfg.fine_matching_topk,
            mutual=cfg.fine_matching_mutual,
            confidence_threshold=cfg.fine_matching_confidence_threshold,
            use_global_score=cfg.fine_matching_use_global_score,
            use_dustbin=cfg.fine_matching_use_dustbin, allow_fast=not train)
        return {"matching_scores": matching_scores, "tgt_corr_points": fine.ref_points,
                "src_corr_points": fine.src_points, "corr_scores": fine.scores,
                "corr_masks": fine.masks}

    def _forward_packed(self, pair: PairInputs, train: bool = False, with_gt: bool = False,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Packed forward (roitr_tpu/models/roitr.py `_forward_packed`): B
        same-bucket pairs as one flat cloud a side (data/packing.py), with
        their pyramids. The point levels run flat on the pyramids' offset
        indices; the global transformer on (B, m4, ...) views, one
        embedding and one RPE attention launch a layer for all B pairs.
        Partition, GT node correspondences and occlusion, coarse matching
        and the patch gathers (`_pair_stage`) run in a Python loop over B on
        free (B, ...) views; the OT runs over all B * P patches in one
        Sinkhorn launch (forward and, in training, backward) and fine
        matching flat over them (the exact path in training). Every output
        gains a leading B; slice b is the single-pair forward of pair b.
        In training each pair samples its own GT patches: JAX splits the
        sampling rng into B keys, the port draws pair b's Gumbel noise b-th
        from the one CPU `generator`, in pair order, so pair b's draw is the
        one a single-pair forward would make after the draws of pairs
        0..b-1."""
        b = pair.src_count.shape[0]
        flat = self._backbone_outputs(pair)
        counts = ("src_count", "tgt_count", "src_node_count", "tgt_node_count")
        views = {k: (v if k in counts else v.reshape(b, v.shape[0] // b, *v.shape[1:]))
                 for k, v in flat.items()}
        pick = lambda t, i: None if t is None else t[i]
        stages = [self._pair_stage({k: v[i] for k, v in views.items()}, pick(pair.rot, i),
                                   pick(pair.trans, i), train, with_gt, generator)
                  for i in range(b)]
        out = dict(views)
        out.update({k: torch.stack([st.outputs[k] for st in stages]) for k in stages[0].outputs})
        # the OT and fine matching take the B * P patches as one flat batch
        patches = _Stage({k: torch.cat([st.outputs[k] for st in stages]) for k in _PATCH_KEYS},
                         *(torch.cat([getattr(st, f) for st in stages])
                           for f in _Stage._fields[1:]))
        out.update({k: v.reshape(b, -1, *v.shape[1:])
                    for k, v in self._ot_and_fine(patches, train=train).items()})
        return out


# the stage outputs that describe the patches (read by the OT's fine matching)
_PATCH_KEYS = ("src_node_corr_knn_points", "tgt_node_corr_knn_points",
               "src_node_corr_knn_masks", "tgt_node_corr_knn_masks")


class _Stage(NamedTuple):
    """What `_pair_stage` hands the OT: its output entries, the patches'
    point features (P, K, C) and the correspondences' masks and scores."""

    outputs: Dict[str, torch.Tensor]
    src_knn_feats: torch.Tensor
    tgt_knn_feats: torch.Tensor
    corr_masks: torch.Tensor
    corr_scores: torch.Tensor
