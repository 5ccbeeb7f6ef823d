"""GeoTransformer serving: `match`'s closed loop on
`Matcher(prep="device", descriptors=True).match` over a seeded pool of raw
XYZ pairs (the traffic of `match`, with its own warm-up count), with
GeoTransformer's numbers for `correct`.

Traffic keys: pool (pairs), points ([lo, hi] a cloud), overlap, warmup
(requests before the window), check (requests the reference checks),
trace_steps (requests in the profiled stretch).

The numbers that decide `correct`, over the checked requests (the largest
pair and check - 1 drawn from the seed):
- node_mismatch: share of stage-2 points and stage-4 nodes not bit-equal
  (a stage of another size counts whole);
- desc_err: the largest error of the fine (stage 2) and the coarse (stage
  4, normalised) features, source and target, over the array's largest
  magnitude;
- corr_mismatch, conf_err: as `judge.match_numbers`: correspondences
  (source and target point) in one set only, over their union; the largest
  confidence gap of a shared one over the reference's largest confidence;
- lgr_gap: |inliers under the program's transform - inliers under the
  reference's| over the latter (at least 1), both counted by the reference
  over its own correspondences at the acceptance radius.

    python3 -m portbench.drivers.geo_match --workload <cell> --seeds <n> [<n> ...] [--fault <f>]

prints the control's numbers a seed, one JSON line each, in one process
without the program: the reference with TF32 on (or a planted fault) in the
program's place, read against the fp32 reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np

from portbench import pools
from portbench.drivers import match

DESC = ("tgt_point_desc", "src_point_desc", "tgt_node_desc", "src_node_desc")
NODES = ("tgt_points", "src_points", "tgt_nodes", "src_nodes")
FAULTS = ("tf32", "no_refinement", "coarse_voxel")


class Driver(match.Driver):
    def bucket(self) -> int:
        """The largest cloud of the pool (no bucket: stages are sized
        exactly)."""
        return max(max(len(s), len(t)) for s, t in self.pool)


def _corr_table(out: Mapping[str, np.ndarray]) -> Dict[bytes, float]:
    keys = np.concatenate([out["src_corr_pts"], out["tgt_corr_pts"]], axis=1)
    keys = np.ascontiguousarray(keys.astype(np.float32))
    return {row.tobytes(): float(c) for row, c in zip(keys, out["confidence"])}


def geo_numbers(prog: List[Mapping[str, np.ndarray]], ref: List[Mapping[str, np.ndarray]],
                radius: float) -> Dict[str, float]:
    """The compared numbers of the program's outputs against the
    reference's, request by request (see the module's docstring)."""
    from portbench.reference.geotransformer import inliers_of

    nodes_total = nodes_bad = 0
    desc = conf = lgr = 0.0
    corr_bad = corr_union = 0
    for p, r in zip(prog, ref):
        for key in NODES:
            a, b = p[key], r[key]
            nodes_total += max(len(a), len(b))
            nodes_bad += (max(len(a), len(b)) if a.shape != b.shape
                          else int(np.any(a != b, axis=-1).sum()))
        for key in DESC:
            a, b = p[key].astype(np.float64), r[key].astype(np.float64)
            scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
            desc = max(desc, float(np.abs(a - b).max(initial=0.0)) / scale
                       if a.shape == b.shape else float("inf"))
        tp, tr = _corr_table(p), _corr_table(r)
        shared = tp.keys() & tr.keys()
        corr_union += len(tp.keys() | tr.keys())
        corr_bad += len(tp.keys() ^ tr.keys())
        top = max(tr.values(), default=0.0)
        if shared and top > 0:
            conf = max(conf, max(abs(tp[k] - tr[k]) for k in shared) / top)
        mine = inliers_of(r, p["transform"].astype(np.float32), radius)
        theirs = inliers_of(r, r["transform"], radius)
        lgr = max(lgr, abs(mine - theirs) / max(theirs, 1))
    return {"node_mismatch": nodes_bad / max(nodes_total, 1), "desc_err": desc,
            "corr_mismatch": corr_bad / max(corr_union, 1), "conf_err": conf, "lgr_gap": lgr}


def reference_numbers(ctx, payload, model, device) -> dict:
    """The reference's answers for the sampled requests, against the
    program's."""
    from portbench.reference import geotransformer as reference

    pool = pools.request_pool(ctx.seed, ctx.traffic)
    ref = [reference.match(model, ctx.ref_cfg, *pool[i], device) for i in payload["sample"]]
    out = geo_numbers(payload["outputs"], ref, ctx.ref_cfg.acceptance_radius)
    out["requests_checked"] = float(len(ref))
    return out


def control(bench: dict, cell: str, seed: int, fault: str = "tf32", device="cuda") -> dict:
    """The cell's numbers with the reference in the program's place: TF32
    on (the precision below the configuration's fp32), or a planted fault
    (no_refinement: LGR stops after its first Procrustes; coarse_voxel: the
    grid's voxel 1% coarser), against the fp32 reference."""
    import copy

    import torch

    from portbench import harness, models
    from portbench.reference import geotransformer as reference

    ctx = harness.make_context(bench, cell, seed, device)
    model = ctx.model.build_reference(ctx.ref_cfg, models.weights(ctx), device)
    pool = pools.request_pool(seed, ctx.traffic)
    sample = pools.check_sample(seed, list(range(len(pool))), pool, ctx.traffic["check"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ref = [reference.match(model, ctx.ref_cfg, *pool[i], device) for i in sample]
    low_cfg = copy.copy(ctx.ref_cfg)
    if fault == "no_refinement":
        low_cfg.num_refinement_steps = 1
    elif fault == "coarse_voxel":
        low_cfg.voxel_size = ctx.ref_cfg.voxel_size * 1.01
    model.cfg = low_cfg
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = fault == "tf32"
    low = [reference.match(model, low_cfg, *pool[i], device) for i in sample]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model.cfg = ctx.ref_cfg
    return geo_numbers(low, ref, ctx.ref_cfg.acceptance_radius)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The control readings of a GeoTransformer cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="tf32", choices=FAULTS)
    args = p.parse_args(argv)
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        numbers = control(bench, args.workload, seed, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.fault,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
