"""Redwood-protocol scene benchmark: registration precision/recall/RRE/RTE.

The port's own copy of roitr_tpu/eval/benchmark.py (numpy, function for
function). Rebuilds reference registration/benchmark.py:217-343 on the
nibabel-free trajectory utilities.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List

import numpy as np

from roitr_torch.eval.trajectory import (
    compute_transformation_error,
    read_trajectory,
    read_trajectory_info,
    rotation_error_deg,
    translation_error,
)


def evaluate_registration(num_fragment, result, result_pairs, gt_pairs, gt, gt_info, err2=0.2):
    """Reference benchmark.py:217-273. Recall counts only non-consecutive
    pairs; success = transformation RMSE <= err2."""
    err2 = err2**2
    gt_mask = np.zeros((num_fragment, num_fragment), dtype=int)
    flags: List[int] = []
    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if j - i > 1:
            gt_mask[i, j] = idx
    n_gt = np.sum(gt_mask > 0)

    good, n_res = 0, 0
    for idx in range(result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        pose = result[idx]
        if gt_mask[i, j] > 0:
            n_res += 1
            gt_idx = gt_mask[i, j]
            p = compute_transformation_error(
                np.linalg.inv(gt[gt_idx]) @ pose, gt_info[gt_idx]
            )
            if p <= err2:
                good += 1
                flags.append(0)
            else:
                flags.append(1)
        else:
            flags.append(2)
    if n_res == 0:
        n_res = int(1e6)
    return good / n_res, good / max(n_gt, 1), flags


def extract_corresponding_trajectories(est_pairs, gt_pairs, gt_traj):
    ext = np.zeros((len(est_pairs), 4, 4))
    for est_idx, pair in enumerate(est_pairs):
        pair = list(pair)
        pair[2] = gt_pairs[0][2]
        gt_idx = np.where((gt_pairs == pair).all(axis=1))[0]
        ext[est_idx] = gt_traj[gt_idx]
    return ext


SHORT_NAMES = ["Kitchen", "Home 1", "Home 2", "Hotel 1", "Hotel 2", "Hotel 3", "Study", "MIT Lab"]


def benchmark(est_folder: str, gt_folder: str) -> dict:
    """Per-scene + aggregate registration metrics; writes `result` file
    (reference benchmark.py:276-343). Returns the aggregates."""
    scenes = sorted(os.listdir(gt_folder))
    scene_paths = [os.path.join(gt_folder, s) for s in scenes]

    re_per, te_per = defaultdict(list), defaultdict(list)
    precision, recall, n_valids = [], [], []
    short = SHORT_NAMES if len(scenes) == len(SHORT_NAMES) else scenes

    with open(os.path.join(est_folder, "result"), "w") as f:
        f.write("Scene\t| prec.\t| rec.\t| re\t| te\t| samples\t|\n")
        for idx, scene in enumerate(scene_paths):
            gt_pairs, gt_traj = read_trajectory(os.path.join(scene, "gt.log"))
            n_valid = sum(abs(int(e[0]) - int(e[1])) > 1 for e in gt_pairs)
            n_valids.append(n_valid)
            n_fragments, gt_cov = read_trajectory_info(os.path.join(scene, "gt.info"))
            est_pairs, est_traj = read_trajectory(
                os.path.join(est_folder, scenes[idx], "est.log")
            )
            prec, rec, flags = evaluate_registration(
                n_fragments, est_traj, est_pairs, gt_pairs, gt_traj, gt_cov
            )
            ext_gt = extract_corresponding_trajectories(est_pairs, gt_pairs, gt_traj)
            sel = np.array(flags) == 0
            re = rotation_error_deg(ext_gt[:, :3, :3], est_traj[:, :3, :3])[sel]
            te = translation_error(ext_gt[:, :3, 3:4], est_traj[:, :3, 3:4])[sel]
            if re.size:
                for agg, vals in (("mean", np.mean), ("median", np.median)):
                    re_per[agg].append(vals(re))
                    te_per[agg].append(vals(te))
            precision.append(prec)
            recall.append(rec)
            f.write(
                f"{short[idx]}\t| {prec:.3f}\t| {rec:.3f}\t| "
                f"{np.median(re) if re.size else 0:.3f}\t| "
                f"{np.median(te) if te.size else 0:.3f}\t| {n_valid:3d}|\n"
            )
            np.save(os.path.join(est_folder, scenes[idx], "flag.npy"), flags)

        weighted_recall = float(
            (np.array(n_valids) * np.array(recall)).sum() / max(np.sum(n_valids), 1)
        )
        out = {
            "mean_precision": float(np.mean(precision)),
            "mean_recall": float(np.mean(recall)),
            "weighted_recall": weighted_recall,
            "mean_median_rre": float(np.mean(re_per["median"])) if re_per["median"] else 0.0,
            "mean_median_rte": float(np.mean(te_per["median"])) if te_per["median"] else 0.0,
        }
        f.write(f"Mean precision: {out['mean_precision']:.3f}\n")
        f.write(f"Mean recall: {out['mean_recall']:.3f}\n")
        f.write(f"Weighted recall: {out['weighted_recall']:.3f}\n")
        f.write(f"Mean median RRE: {out['mean_median_rre']:.3f}\n")
        f.write(f"Mean median RTE: {out['mean_median_rte']:.3f}\n")
    return out
