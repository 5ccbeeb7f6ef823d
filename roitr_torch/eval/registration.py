"""Coarse-to-fine registration evaluation over dumped correspondences.

The port's counterpart of roitr_tpu/eval/registration.py: the reference's
registration/evaluate_registration_c2f.py and its _rotated variant as
functions and a CLI, over the Tester's dumps (eval/tester.py, the
reference's keys, lib/tester.py:56-68). RANSAC runs on a card
(`ransac_backend="torch"`, eval/ransac_torch.py, the default of the
functions and of the CLI; `device="cpu"` runs it on the host) or with the
numpy backend on request (`ransac_backend="numpy"`, eval/ransac.py):

    python -m roitr_torch.eval.registration --source_path snapshot/<exp_dir>/3DMatch \
        --benchmark 3DMatch --n_points 5000      # --device cpu without a card

It prints registration recall, inlier ratio (IR) and feature-match recall
(FMR), and writes the estimated trajectories and a `result` file under
`--exp_dir`.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Optional

import numpy as np

from roitr_torch.eval.benchmark import benchmark
from roitr_torch.eval.ransac import (
    get_inlier_ratio_correspondence,
    ransac_pose_estimation_correspondences,
)
from roitr_torch.eval.ransac_torch import ransac_pose_estimation_correspondences_torch
from roitr_torch.eval.tester import list_dumps, load_dump
from roitr_torch.eval.trajectory import read_trajectory, write_est_trajectory


def _ransac_fn(backend: str, device="cuda"):
    """'numpy' (the reference protocol on the host) or 'torch' (the same
    hypotheses, all of a pair at once on `device`)."""
    if backend == "numpy":
        return ransac_pose_estimation_correspondences
    if backend == "torch":
        return partial(ransac_pose_estimation_correspondences_torch, device=device)
    if backend == "jax":
        raise ValueError("ransac_backend 'jax' is the JAX package's; the port runs RANSAC on "
                         "a card with ransac_backend='torch'")
    raise ValueError(f"unknown ransac backend {backend!r} (numpy or torch)")


def resolve_gt_folder(whichbenchmark: str) -> str:
    """Locate the Redwood ground-truth folder (gt.log/gt.info per scene).

    The repo vendors the published 3DMatch/3DLoMatch benchmark metadata under
    `configs/benchmarks/` (same data the reference ships,
    reference configs/benchmarks/3DMatch/*/gt.log), so the protocol runs out
    of the box from any CWD; a relative `configs/benchmarks` next to the CWD
    still wins for user-supplied splits."""
    candidates = [
        os.path.join("configs", "benchmarks", whichbenchmark),
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
            "configs", "benchmarks", whichbenchmark,
        ),
    ]
    for c in candidates:
        if os.path.isdir(c):
            return c
    raise FileNotFoundError(
        f"no ground-truth folder for benchmark {whichbenchmark!r}; looked in "
        f"{candidates} — pass gt_folder= explicitly"
    )


def sample_correspondences(
    rng: np.random.RandomState,
    src_corr: np.ndarray,
    tgt_corr: np.ndarray,
    confidence: np.ndarray,
    n_points: int,
):
    """Confidence-weighted sampling without replacement
    (reference evaluate_registration_c2f.py:80-85). Falls back to uniform
    when confidences are degenerate (all-zero dumps from untrained nets)."""
    if confidence.shape[0] > n_points:
        total = float(confidence.sum())
        if total > 0 and np.isfinite(total):
            prob = confidence / total
            sel = rng.choice(prob.shape[0], n_points, replace=False, p=prob)
        else:
            sel = rng.choice(confidence.shape[0], n_points, replace=False)
        return src_corr[sel], tgt_corr[sel], confidence[sel]
    return src_corr, tgt_corr, confidence


def benchmark_registration(
    desc_dir: str,
    exp_dir: str,
    whichbenchmark: str,
    n_points: int,
    gt_folder: Optional[str] = None,
    inlier_ratio_threshold: float = 0.05,
    seed: int = 0,
    ransac_iterations: int = 50000,
    ransac_backend: str = "torch",
    device="cuda",
) -> Dict[str, float]:
    """Full protocol: sample -> RANSAC -> IR -> Redwood RR -> FMR
    (reference evaluate_registration_c2f.py:44-118). RANSAC runs on the
    card unless the caller asks otherwise: `device` is where the torch
    backend runs, `ransac_backend="numpy"` runs the reference's on the
    host."""
    ransac_fn = _ransac_fn(ransac_backend, device)
    if gt_folder is None:
        gt_folder = resolve_gt_folder(whichbenchmark)
    out_dir = os.path.join(exp_dir, whichbenchmark, str(n_points))
    os.makedirs(out_dir, exist_ok=True)

    rng = np.random.RandomState(seed)
    tsfm_est, inlier_ratios = [], []
    for path in list_dumps(desc_dir):
        data = load_dump(path)
        src_corr, tgt_corr, conf = sample_correspondences(
            rng, data["src_corr_pts"], data["tgt_corr_pts"], data["confidence"], n_points
        )
        tsfm_est.append(
            ransac_fn(
                src_corr, tgt_corr, max_iterations=ransac_iterations, seed=seed
            )
        )
        inlier_ratios.append(
            get_inlier_ratio_correspondence(
                src_corr, tgt_corr, data["rot"], data["trans"], 0.1
            )
        )

    tsfm_est = np.asarray(tsfm_est)
    write_est_trajectory(gt_folder, out_dir, tsfm_est)
    reg = benchmark(out_dir, gt_folder)

    # per-scene IR / FMR aggregation (reference :105-118)
    inlier_ratios = np.asarray(inlier_ratios)
    scenes = sorted(os.listdir(gt_folder))
    split, count = [], 0
    for s in scenes:
        gt_pairs, _ = read_trajectory(os.path.join(gt_folder, s, "gt.log"))
        split.append((count, count + len(gt_pairs)))
        count += len(gt_pairs)
    inliers = [np.mean(inlier_ratios[a:b]) for a, b in split if b > a]
    fmrs = [(inlier_ratios[a:b] > inlier_ratio_threshold).mean() for a, b in split if b > a]

    result = {
        "inlier_ratio": float(np.mean(inliers)) if inliers else 0.0,
        "feature_match_recall": float(np.mean(fmrs)) if fmrs else 0.0,
        **reg,
    }
    with open(os.path.join(out_dir, "result"), "a") as f:
        f.write(f"Inlier ratio: {result['inlier_ratio']:.3f}\n")
        f.write(f"Feature match recall: {result['feature_match_recall']:.3f}\n")
    return result


def benchmark_registration_rotated(
    desc_dir: str,
    exp_dir: str,
    whichbenchmark: str,
    n_points: int,
    rmse_threshold: float = 0.2,
    inlier_ratio_threshold: float = 0.05,
    seed: int = 0,
    ransac_iterations: int = 50000,
    ransac_backend: str = "torch",
    device="cuda",
) -> Dict[str, float]:
    """Rotated-benchmark protocol: RMSE-based registration recall computed
    directly against the per-pair GT (reference
    evaluate_registration_c2f_rotated.py:40-116) — no Redwood covariances
    (the random rotations invalidate them). RANSAC runs as in
    `benchmark_registration`: on the card unless asked otherwise.
    """
    ransac_fn = _ransac_fn(ransac_backend, device)
    out_dir = os.path.join(exp_dir, whichbenchmark + "_rotated", str(n_points))
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    recalls, inlier_ratios = [], []
    for path in list_dumps(desc_dir):
        data = load_dump(path)
        src_corr, tgt_corr, conf = sample_correspondences(
            rng, data["src_corr_pts"], data["tgt_corr_pts"], data["confidence"], n_points
        )
        tsfm = ransac_fn(
            src_corr, tgt_corr, max_iterations=ransac_iterations, seed=seed
        )
        inlier_ratios.append(
            get_inlier_ratio_correspondence(src_corr, tgt_corr, data["rot"], data["trans"], 0.1)
        )
        # RMSE of the GT-overlap src points under est vs gt transform
        src_pcd = data["src_pcd"]
        rot, trans = data["rot"], data["trans"].reshape(1, 3)
        gt_warp = src_pcd @ rot.T + trans
        est_warp = src_pcd @ tsfm[:3, :3].T + tsfm[:3, 3]
        rmse = np.sqrt(((gt_warp - est_warp) ** 2).sum(-1).mean())
        recalls.append(float(rmse < rmse_threshold))

    inlier_ratios = np.asarray(inlier_ratios)
    result = {
        "registration_recall": float(np.mean(recalls)) if recalls else 0.0,
        "inlier_ratio": float(np.mean(inlier_ratios)) if inlier_ratios.size else 0.0,
        "feature_match_recall": float((inlier_ratios > inlier_ratio_threshold).mean())
        if inlier_ratios.size
        else 0.0,
    }
    with open(os.path.join(out_dir, "result"), "w") as f:
        for k, v in result.items():
            f.write(f"{k}: {v:.3f}\n")
    return result


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--source_path", required=True, help="directory of dumped pairs")
    parser.add_argument("--benchmark", default="3DMatch")
    parser.add_argument("--n_points", type=int, default=1000)
    parser.add_argument("--exp_dir", default="est_traj")
    parser.add_argument("--rotated", action="store_true")
    parser.add_argument("--gt_folder", default=None)
    parser.add_argument(
        "--ransac_backend", default="torch", choices=("torch", "numpy"),
        help="'torch' runs each pair's hypotheses at once on --device; 'numpy' on the host")
    parser.add_argument("--device", default="cuda", help="the torch backend's device")
    args = parser.parse_args(argv)

    if args.rotated:
        res = benchmark_registration_rotated(
            args.source_path, args.exp_dir, args.benchmark, args.n_points,
            ransac_backend=args.ransac_backend, device=args.device,
        )
    else:
        res = benchmark_registration(
            args.source_path, args.exp_dir, args.benchmark, args.n_points,
            gt_folder=args.gt_folder, ransac_backend=args.ransac_backend, device=args.device,
        )
    for k, v in res.items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
