"""Non-rigid (4DMatch / 4DLoMatch) evaluation of the Tester's dumps: NFMR
and inlier ratio.

Counterpart of roitr_tpu/eval/fdmatch_eval.py (reference
registration/evaluate_fdmatch.py:40-185): the predicted motion of the
matched points is blended onto the metric points by 3-NN inverse-distance
weights (search radius 0.1), and recall is measured at 0.04.

    python -m roitr_torch.eval.fdmatch_eval --source_path snapshot/<exp_dir>/4DMatch
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from roitr_torch.eval.tester import list_dumps, load_dump


def knn_np(reference: np.ndarray, query: np.ndarray, k: int):
    """(distances, indices), each (len(query), k), of the k nearest
    reference points of every query point."""
    from scipy.spatial import cKDTree

    d, idx = cKDTree(reference).query(query, k=k)
    if k == 1:
        d, idx = d[:, None], idx[:, None]
    return d, idx


def blend_anchor_motion(query_loc, reference_loc, reference_flow, knn=3, search_radius=0.1):
    """The flow at the query points, inverse-distance blended from the knn
    nearest reference points within the radius (reference
    evaluate_fdmatch.py:50-71); `invalid` marks queries with none."""
    dists, idx = knn_np(reference_loc, query_loc, knn)
    dists = np.clip(dists, 1e-10, None)
    mask = dists > search_radius
    dists = np.where(mask, 1e10, dists)
    weight = 1.0 / dists
    weight = weight / weight.sum(-1, keepdims=True)
    blended = (reference_flow[idx] * weight[..., None]).sum(axis=1)
    invalid = mask.sum(axis=1) >= knn
    return blended, invalid


def compute_nrfmr(data: Dict[str, np.ndarray], recall_thr: float = 0.04) -> float:
    """Non-rigid feature match recall of one pair (reference
    evaluate_fdmatch.py:74-115): the share of metric points whose blended
    predicted position lies within `recall_thr` of the ground truth."""
    s_pcd = np.asarray(data["src_raw_pcd"])
    s_deformed = np.asarray(data["src_pcd"])
    sflow = s_deformed - s_pcd
    metric_index = np.asarray(data["metric_index_list"]).reshape(-1)
    rot = np.asarray(data["rot"])
    trans = np.asarray(data["trans"]).reshape(3, 1)

    metric_pcd = s_pcd[metric_index]
    metric_deformed = metric_pcd + sflow[metric_index]
    metric_gt = (rot @ metric_deformed.T + trans).T

    s_matched = np.asarray(data["src_corr_pts"])  # in the deformed frame
    t_matched = np.asarray(data["tgt_corr_pts"])
    if s_matched.shape[0] == 0:
        return 0.0
    # the matched deformed-source points back to their raw positions
    _, idx = knn_np(s_deformed, s_matched, 1)
    s_matched_raw = s_pcd[idx[:, 0]]
    motion_pred = t_matched - s_matched_raw

    metric_motion, _ = blend_anchor_motion(metric_pcd, s_matched_raw, motion_pred, knn=3,
                                           search_radius=0.1)
    metric_pred = metric_pcd + metric_motion
    dist = np.sqrt(((metric_pred - metric_gt) ** 2).sum(axis=1))
    return float((dist < recall_thr).sum() / len(dist))


def compute_inlier_ratio(data: Dict[str, np.ndarray], thr: float = 0.04) -> float:
    """Share of correspondences whose deformed source point, moved by the
    rigid GT transform, lies within `thr` of its target point."""
    src = np.asarray(data["src_corr_pts"])
    tgt = np.asarray(data["tgt_corr_pts"])
    if src.shape[0] == 0:
        return 0.0
    rot = np.asarray(data["rot"])
    trans = np.asarray(data["trans"]).reshape(1, 3)
    d = np.linalg.norm(src @ rot.T + trans - tgt, axis=1)
    return float((d < thr).mean())


def evaluate_fdmatch(desc_dir: str, recall_thr: float = 0.04) -> Dict[str, float]:
    """Mean NFMR and IR over the dumps of a directory."""
    nfmrs, irs = [], []
    for path in list_dumps(desc_dir):
        data = load_dump(path)
        nfmrs.append(compute_nrfmr(data, recall_thr))
        irs.append(compute_inlier_ratio(data, recall_thr))
    return {"NFMR": float(np.mean(nfmrs)) if nfmrs else 0.0,
            "IR": float(np.mean(irs)) if irs else 0.0}


def main():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source_path", required=True,
                        help="directory of the Tester's dumps, <i>.pth")
    parser.add_argument("--recall_thr", type=float, default=0.04)
    args = parser.parse_args()
    for k, v in evaluate_fdmatch(args.source_path, args.recall_thr).items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
