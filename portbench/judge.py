"""The numbers that decide `correct`: the program's outputs against the
reference's, each number beside its limit.

Serving (`match_numbers`), over the sampled requests:
- node_mismatch: share of coarse nodes not bit-equal (FPS is exact);
- desc_err: the largest distance of a descriptor row (node and point,
  source and target) from the reference's, over the RMS norm of that
  array's reference rows;
- corr_mismatch: share of correspondences (source and target point) in
  one set and not the other, over their union;
- conf_err: the largest gap of a shared correspondence's confidence, over
  the reference's largest confidence.

Training (`train_numbers`), over the first update(s):
- loss_gap: the largest relative gap of a mini-step's loss;
- grad_gap: the worst leaf's gap between the norms of the first gradient
  as Adam receives it, over the larger of the reference leaf's norm and
  the median leaf's;
- delta_gap: the same for each leaf's change over the followed updates,
  leaving out leaves whose raw reference gradient is under a thousandth of
  the median leaf's (they move under Adam by rounding alone).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

DESC_KEYS = ("src_node_desc", "tgt_node_desc", "src_point_desc", "tgt_point_desc")


def _rows_err(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    scale = float(np.sqrt(np.mean(np.sum(ref.astype(np.float64) ** 2, axis=-1))))
    err = np.linalg.norm(prog.astype(np.float64) - ref.astype(np.float64), axis=-1)
    return float(err.max()) / max(scale, 1e-30) if err.size else 0.0


def _corr_table(out: Mapping[str, np.ndarray]) -> Dict[bytes, float]:
    keys = np.concatenate([out["src_corr_pts"], out["tgt_corr_pts"]], axis=1)
    keys = np.ascontiguousarray(keys.astype(np.float32))
    return {row.tobytes(): float(c) for row, c in zip(keys, out["confidence"])}


def match_numbers(prog: List[Mapping[str, np.ndarray]],
                  ref: List[Mapping[str, np.ndarray]]) -> Dict[str, float]:
    nodes_total = nodes_bad = 0
    desc = corr_bad = corr_union = 0.0
    conf = 0.0
    for p, r in zip(prog, ref):
        for side in ("src_nodes", "tgt_nodes"):
            a, b = p[side], r[side]
            nodes_total += max(len(a), len(b))
            if a.shape != b.shape:
                nodes_bad += max(len(a), len(b))
            else:
                nodes_bad += int(np.any(a != b, axis=-1).sum())
        desc = max([desc] + [_rows_err(p[k], r[k]) for k in DESC_KEYS])
        tp, tr = _corr_table(p), _corr_table(r)
        shared = tp.keys() & tr.keys()
        corr_union += len(tp.keys() | tr.keys())
        corr_bad += len(tp.keys() ^ tr.keys())
        top = max(tr.values(), default=0.0)
        if shared and top > 0:
            conf = max(conf, max(abs(tp[k] - tr[k]) for k in shared) / top)
    return {"node_mismatch": nodes_bad / max(nodes_total, 1), "desc_err": desc,
            "corr_mismatch": corr_bad / max(corr_union, 1.0), "conf_err": conf}


def _norm_gap(prog: Mapping[str, float], ref: Mapping[str, float], keys) -> float:
    keys = list(keys)
    if set(prog) != set(ref) or not keys:
        return float("inf")
    median = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys)


def train_numbers(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    lp, lr = prog["losses"], ref["losses"]
    loss_gap = (max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
                if len(lp) == len(lr) and all(np.isfinite(lp)) else float("inf"))
    raw = ref["raw_grad_norms"]
    median = float(np.median(list(raw.values())))
    moving = [k for k, v in raw.items() if v >= 1e-3 * median]
    return {"loss_gap": loss_gap,
            "grad_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"]),
            "delta_gap": _norm_gap(prog["delta_norms"], ref["delta_norms"], moving)}


def train_report(prog: Mapping, ref: Mapping, worst: int = 3) -> str:
    """One line for the log: both sides' losses, and the leaves that set
    grad_gap and delta_gap, each with its gap and both norms."""
    def top(key):
        p, r = prog[key], ref[key]
        median = float(np.median(list(r.values())))
        gaps = sorted(((abs(p[k] - r[k]) / max(r[k], median, 1e-30), k) for k in r if k in p),
                      reverse=True)[:worst]
        return ", ".join(f"{k} {g:.3g} ({p[k]:.6g} vs {r[k]:.6g})" for g, k in gaps)
    return (f"losses {[float(x) for x in prog['losses']]} vs {[float(x) for x in ref['losses']]}; "
            f"grad: {top('grad_norms')}; delta: {top('delta_norms')}")


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number at or under its limit (a number without a reading, or
    NaN, fails)."""
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)
