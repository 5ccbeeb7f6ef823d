"""Typed configuration for the roitr_torch pipeline (a copy of the JAX
package's Config, so the port imports nothing from it).

Replaces the reference's two-level YAML flattened into a mutable EasyDict
(reference: configs/utils.py:4-18, main.py:46) with an immutable dataclass.
YAML files with the same two-level section structure are accepted; sections
are flattened and validated against the known field set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- misc ----
    exp_dir: str = "exp"
    mode: str = "train"  # train | val | test
    verbose: bool = True
    verbose_freq: int = 10
    seed: int = 42

    # ---- model ----
    pretrain: str = ""
    transformer_architecture: Sequence[str] = (
        "self", "cross", "self", "cross", "self", "cross",
    )
    with_cross_pos_embed: bool = True
    benchmark: str = "3DMatch"  # 3DMatch | 3DLoMatch | 4DMatch | 4DLoMatch
    num_heads: int = 4
    enc_blocks: Sequence[int] = (2, 3, 3, 3)
    enc_strides: Sequence[int] = (1, 4, 4, 4)
    enc_nsample: Sequence[int] = (8, 16, 16, 16)
    # channel multiplier: 1 for rigid (3DMatch), 2 for non-rigid (4DMatch)
    # (reference: model/RIGA_v2.py:24,28)
    # derived from benchmark; override only for experiments
    factor: Optional[int] = None

    # ---- numerics ----
    # float32 | bfloat16: the dtype every Linear and LayerNorm of the backbone
    # and the global transformer computes in (fp32 parameters); geometry,
    # the geometric embedding, descriptors, OT and losses stay fp32
    compute_dtype: str = "float32"

    # ---- optim ----
    optimizer: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 1e-6
    momentum: float = 0.98
    scheduler: str = "ExpLR"
    scheduler_gamma: float = 0.95
    iter_size: int = 1

    # ---- data ----
    dataset: str = "tdmatch"
    root: str = "data/indoor"
    train_info: str = ""
    val_info: str = ""
    # test-split override (extension): empty -> the reference's resolution,
    # configs/tdmatch/<benchmark>.pkl (dataset/dataloader.py:18; vendored)
    test_info: str = ""
    augment_noise: float = 0.005
    rotated: bool = False
    points_limit: int = 30000
    # static shape buckets (multiples of 64 so every pyramid level is exact)
    buckets: Sequence[int] = (4096, 8192, 16384, 24576, 32768)
    normal_knn: int = 33
    # precompute the FPS/kNN pyramids on the host (data/pyramid.py, the
    # native library), so the forward runs no search; False: the backbone
    # runs FPS and kNN on the device
    host_pyramid: bool = False
    # per-pair geometry prep on the device: the datasets ship zero normals
    # and the Tester estimates them on the device (ops/pyramid.py
    # device_prep_pair) before the forward
    device_prep: bool = False
    # test-split dump payload of the Tester (eval/tester.py): "full" (every
    # key the reference dumps) or "c2f" (what the registration evaluators
    # read, correspondences compacted to at most dump_corr_cap rows)
    dump_mode: str = "full"
    dump_corr_cap: int = 16384

    # ---- coarse matching ----
    matching_radius: float = 0.05
    num_gt_coarse_corr: int = 128
    num_est_coarse_corr: int = 256
    coarse_overlap_threshold: float = 0.1
    # cap for statically-shaped GT node-correspondence candidates
    max_gt_corr_candidates: int = 16384
    # non-rigid adaptive matching (reference RIGA_v2.py:27 hardcodes 0.75;
    # exposed here so the 4D configs can tune it)
    coarse_similarity_threshold: float = 0.75
    # static capacity of the adaptive-matching correspondence buffer;
    # None = max(4 * num_est_coarse_corr, 512)
    coarse_corr_capacity: Optional[int] = None

    # ---- fine matching ----
    point_per_patch: int = 64
    fine_matching_topk: int = 3
    fine_matching_mutual: bool = True
    fine_matching_confidence_threshold: float = 0.05
    fine_matching_use_dustbin: bool = False
    fine_matching_use_global_score: bool = False
    fine_matching_correspondence_threshold: int = 3
    sinkhorn_iters: int = 100
    # "pallas" (default): the hand-written Sinkhorn kernel on the card, its
    # plain torch loop on the CPU; "xla": the plain loop everywhere. The
    # names are the JAX package's, so its configs load unchanged.
    sinkhorn_backend: str = "pallas"
    # > 0 stops inference's Sinkhorn loop once the largest row-potential
    # update is <= tol (capped at sinkhorn_iters) wherever the kernel does
    # not run: on the CPU, under "xla", for a patch the kernel refuses. The
    # kernel runs the fixed count and warns, as the JAX package's kernel
    # path does; training keeps the fixed count. 0.0 = fixed-count
    # iteration (reference model/modules.py:55).
    sinkhorn_tol: float = 0.0
    # backbone neighborhood search: "exact", or "approx" (the JAX package's
    # TPU approx_min_k, which XLA computes exactly off the TPU): the port
    # runs the exact search for both
    knn_method: str = "exact"
    # recompute the backbone's local attention in the backward instead of
    # keeping its activations (the JAX package's memory lever)
    remat_local: bool = False
    # storage dtype of the global transformer's (N, N, hidden) geometric
    # embedding: "bf16" (default; halves the bytes the RPE attention reads)
    # or "fp32" (the reference's fp32 tensor)
    geo_embedding_storage: str = "bf16"

    # ---- coarse loss ----
    coarse_loss_positive_margin: float = 0.1
    coarse_loss_negative_margin: float = 1.4
    coarse_loss_positive_optimal: float = 0.1
    coarse_loss_negative_optimal: float = 1.4
    coarse_loss_log_scale: float = 24.0
    coarse_loss_positive_overlap: float = 0.1
    coarse_loss_weight: float = 1.0

    # ---- fine loss ----
    fine_loss_positive_radius: float = 0.05
    fine_loss_weight: float = 1.0
    occ_loss_weight: float = 0.0

    # ---- eval ----
    eval_acceptance_overlap: float = 0.0
    eval_acceptance_radius: float = 0.1

    # ---- train loop ----
    max_epoch: int = 150
    batch_size: int = 1
    training_max_iter: int = 3500
    val_max_iter: int = 500
    scheduler_interval: int = 1
    snapshot_interval: int = 1
    # preprocessing worker subprocesses of the Trainer's loader and the
    # Tester (data/worker_pool.py), at most one a core
    num_workers: int = 8

    # ---- parallelism ----
    # number of data-parallel shards; None = all local devices
    dp_size: Optional[int] = None
    # batch_size > 1 pairs per device as ONE packed flat cloud
    # (data/packing.py) instead of a vmapped stack — amortizes the fixed
    # pool that dominates small buckets (tools/probe_small_buckets.py).
    # Requires host_pyramid. The reference cannot batch at all.
    packed_batch: bool = False

    @property
    def channel_factor(self) -> int:
        if self.factor is not None:
            return self.factor
        return 1 if self.benchmark in ("3DMatch", "3DLoMatch") else 2

    @property
    def is_rigid(self) -> bool:
        return self.benchmark in ("3DMatch", "3DLoMatch")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name for f in dataclasses.fields(Config)}

# Keys that appear in the reference's YAMLs but are dead in its live code
# path (RIGA-v1 legacy; verified unused outside configs by grep). Tolerated
# silently so upstream configs load unchanged; anything else unknown warns —
# a typo'd key must not silently train with the default.
_REFERENCE_ONLY_KEYS = frozenset({
    "data_root", "decentralization", "descriptor_dim", "gpu_mode",
    "input_type", "local_out_dim", "loss_type", "max_neighbors",
    "overlap_radius", "patch_per_frame", "patch_vicinity", "pos_margin",
    "proj_dim", "ratio_drop", "resample", "safe_radius", "self_training",
    "split", "transformer_angle_k", "transformer_feats_dim",
    "transformer_num_head", "transformer_sigma_a", "transformer_sigma_d",
    "with_transformer",
    # reference DDP launch plumbing (main.py:21): meaningless here
    "local_rank",
})


def load_config(path: str, **overrides) -> Config:
    """Load a two-level YAML config (same layout as the reference's
    configs/train/*.yaml) into a flat, validated Config.

    Unknown keys outside the reference-only allowlist are dropped with a
    warning (not an error, so experimental upstream YAMLs still load)."""
    import logging

    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    flat = {}
    for section, body in raw.items():
        if isinstance(body, dict):
            for k, v in body.items():
                if k in flat:
                    raise ValueError(f"duplicate config key {k!r} in section {section!r}")
                flat[k] = v
        else:
            flat[section] = body
    flat.update(overrides)
    unknown = set(flat) - _FIELDS
    for k in sorted(unknown):
        flat.pop(k)
        if k not in _REFERENCE_ONLY_KEYS:
            logging.getLogger("roitr_torch").warning(
                "config %s: unknown key %r ignored (not a Config field; "
                "check for typos)", path, k,
            )
    if "transformer_architecture" in flat:
        flat["transformer_architecture"] = tuple(flat["transformer_architecture"])
    return Config(**flat)
