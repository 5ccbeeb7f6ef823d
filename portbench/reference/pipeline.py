"""The reference's entry points: a served request and the first training
updates, from raw inputs, in plain PyTorch fp32.

`match` does what a request does (normals from the raw points, bucket
padding, the forward, the correspondences trimmed by their masks, the
descriptors trimmed by the counts); `follow_training` takes the first
updates of training from the same weights and pairs (forward with ground
truth, the losses, autograd's gradients, Adam with coupled L2 and gradient
averaging over `iter_size` pairs) and reports what the benchmark compares.
This file imports nothing of the program.
"""

from __future__ import annotations

import types
from typing import Dict, List, Mapping

import numpy as np
import torch

from portbench.reference import ops
from portbench.reference.model import RoITrReference, loss


def config(values: Mapping) -> types.SimpleNamespace:
    """The configuration file's values, with the two derived ones: the
    channel factor (1 rigid, 2 non-rigid) and whether matching is rigid."""
    cfg = types.SimpleNamespace(**dict(values))
    cfg.is_rigid = cfg.benchmark in ("3DMatch", "3DLoMatch")
    cfg.factor = 1 if cfg.is_rigid else 2
    return cfg


def build(cfg, state_dict: Mapping[str, torch.Tensor], device) -> RoITrReference:
    model = RoITrReference(cfg).to(device)
    model.load_state_dict(state_dict)
    return model


def pick_bucket(n: int, buckets) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return sorted(buckets)[-1]


def _pad(points: np.ndarray, bucket: int, device) -> torch.Tensor:
    out = torch.zeros((bucket, 3), dtype=torch.float32, device=device)
    out[:len(points)] = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    return out


def request_inputs(cfg, src: np.ndarray, tgt: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """A request's padded pair with normals estimated on the device from
    the raw points (kNN PCA, toward the origin) and features of ones."""
    bucket = pick_bucket(max(len(src), len(tgt)), cfg.buckets)
    sp, tp = _pad(src, bucket, device), _pad(tgt, bucket, device)
    sc = torch.tensor(len(src), dtype=torch.int64, device=device)
    tc = torch.tensor(len(tgt), dtype=torch.int64, device=device)
    ones = torch.ones((bucket, 1), dtype=torch.float32, device=device)
    return dict(src_points=sp, src_raw_points=sp, src_normals=ops.estimate_normals(
        sp, sc, cfg.normal_knn), src_feats=ones, src_count=sc, tgt_points=tp,
        tgt_normals=ops.estimate_normals(tp, tc, cfg.normal_knn), tgt_feats=ones, tgt_count=tc)


@torch.no_grad()
def match(model: RoITrReference, cfg, src: np.ndarray, tgt: np.ndarray, device) -> dict:
    """Correspondences (rows of src xyz, tgt xyz, confidence with a true
    mask) and the node and point descriptors of the valid rows."""
    out = model(request_inputs(cfg, src, tgt, device))
    keep = out["corr_masks"]
    sc, tc = len(src), len(tgt)
    snc, tnc = int(out["src_node_count"]), int(out["tgt_node_count"])
    n = lambda t: t.float().cpu().numpy()  # noqa: E731
    return {
        "src_nodes": n(out["src_nodes"][:snc]),
        "tgt_nodes": n(out["tgt_nodes"][:tnc]),
        "src_corr_pts": n(out["src_corr_points"][keep]),
        "tgt_corr_pts": n(out["tgt_corr_points"][keep]),
        "confidence": n(out["corr_scores"][keep]),
        "src_node_desc": n(out["src_node_feats"][:snc]),
        "tgt_node_desc": n(out["tgt_node_feats"][:tnc]),
        "src_point_desc": n(out["src_point_feats"][:sc]),
        "tgt_point_desc": n(out["tgt_point_feats"][:tc]),
    }


def train_inputs(item: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A training item (padded numpy arrays with normals, counts and the
    ground-truth motion) on the device."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    c = lambda a: torch.tensor(int(a), dtype=torch.int64, device=device)  # noqa: E731
    return dict(src_points=t(item["src_points"]), src_raw_points=t(item["src_raw_points"]),
                src_normals=t(item["src_normals"]), src_feats=t(item["src_feats"]),
                src_count=c(item["src_count"]), tgt_points=t(item["tgt_points"]),
                tgt_normals=t(item["tgt_normals"]), tgt_feats=t(item["tgt_feats"]),
                tgt_count=c(item["tgt_count"]), rot=t(item["rot"]), trans=t(item["trans"]))


def follow_training(model: RoITrReference, cfg, items: List[Mapping[str, np.ndarray]],
                    generator, updates: int, device) -> dict:
    """The first `updates` optimizer updates of training, `cfg.iter_size`
    pairs each (items in order, one pair a mini-step; the pairs of one
    data-parallel step are the same as the mini-steps of one update). The
    ground-truth patches' Gumbel noise comes from `generator`, or from
    generator[i] for the i-th pair given a list (one a rank). Returns the
    loss of every mini-step, the per-leaf norms of the first update's
    gradient as Adam receives it (the mean over its pairs plus the L2
    term), of the raw mean gradient, and of each leaf's change over all
    `updates`."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr, betas=(0.9, 0.99), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    iter_size = max(cfg.iter_size, 1)
    losses, first_grad = [], None
    gens = generator if isinstance(generator, list) else [generator] * len(items)
    it = iter(zip(items, gens))
    for u in range(updates):
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        for _ in range(iter_size):
            item, gen = next(it)
            pair = train_inputs(item, device)
            out = model(pair, train=True, with_gt=True, generator=gen)
            value = loss(cfg, out, pair["rot"], pair["trans"])
            grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
            for (k, p), g in zip(params.items(), grads):
                if g is not None:
                    acc[k] += g
            losses.append(float(value.detach()))
        mean = {k: a / iter_size for k, a in acc.items()}
        if u == 0:
            first_grad = {k: (g + cfg.weight_decay * params[k].detach()) for k, g in mean.items()}
            raw = mean
        for k, p in params.items():
            p.grad = mean[k]
        opt.step()
        opt.zero_grad(set_to_none=True)
    return {
        "losses": losses,
        "grad_norms": {k: float(torch.linalg.norm(g)) for k, g in first_grad.items()},
        "raw_grad_norms": {k: float(torch.linalg.norm(g)) for k, g in raw.items()},
        "delta_norms": {k: float(torch.linalg.norm(p.detach() - start[k]))
                        for k, p in params.items()},
    }
