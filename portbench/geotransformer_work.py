"""The work GeoTransformer's equations require for one request, from the
pair's grid pyramid: its stage sizes and each search's valid neighbours
(neighbours within the radius, at most the stage's limit), computed after
the window from each request's recorded (source, target) counts and the
run's seed. Every pool pair has its own counts, so the pool (pools.py) is
rebuilt and the pair found; its pyramid is the reference's grid
(reference/geotransformer.py `grid_subsample`) with neighbours counted by
scipy's KD-tree, cached per seed and pair.

- `request_flops`: the products (two operations a multiply-add) of the
  radius searches' and the partition's distances, every KPConv's weighting
  (kernel points x valid neighbours x input width a query) and kernel
  product (kernel points x input x output width a query), every Linear,
  the geometric embedding's projections and distances, the attention
  products, the coarse matching's distances and the OT scores. The 3 x 3
  products of the registration are left out.
- `launches`: the shapes of each launch of the geo_embedding,
  rpe_attention and sinkhorn kernels, for `roofline.bound_s`, except that
  the RPE attention's bound counts only what GeoTransformer needs: hidden
  states, and no positional output (no A' e products, no second softmax, no
  (N, H, D) output).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from portbench import pools, roofline

_CACHE: Dict[tuple, dict] = {}
WIDTH = 256  # the transformer's and the fine features' width


def _counts(tree, queries: np.ndarray, radius: float, limit: int) -> int:
    """Valid neighbour entries of the queries: within the radius, at most
    `limit` a query."""
    if len(queries) == 0:
        return 0
    found = tree.query_ball_point(queries, radius, return_length=True)
    return int(np.minimum(found, limit).sum())


def pair_pyramid(cfg, ref: np.ndarray, src: np.ndarray) -> dict:
    """{"lengths": [(ref, src) a stage], "neighbors": [valid entries a
    stage], "subsampling": [...], "upsampling": {stage: ...}}."""
    from scipy.spatial import cKDTree

    from portbench.reference.geotransformer import grid_subsample

    clouds = [[ref, src]]
    voxel = cfg.voxel_size
    for _ in range(1, cfg.num_stages):
        voxel *= 2
        clouds.append([grid_subsample(c, voxel) for c in clouds[-1]])
    trees = [[cKDTree(c) for c in cs] for cs in clouds]
    out = {"lengths": [(len(a), len(b)) for a, b in clouds], "neighbors": [],
           "subsampling": [], "upsampling": {}}
    for s in range(cfg.num_stages):
        r, lim = cfg.base_radius * cfg.voxel_size * 2 ** s, cfg.neighbor_limits[s]
        out["neighbors"].append(sum(_counts(trees[s][i], clouds[s][i], r, lim)
                                    for i in range(2)))
        if s + 1 < cfg.num_stages:
            out["subsampling"].append(sum(_counts(trees[s][i], clouds[s + 1][i], r, lim)
                                          for i in range(2)))
            if s > 0:
                out["upsampling"][s] = sum(_counts(trees[s + 1][i], clouds[s][i], 2 * r, 1)
                                           for i in range(2))
    return out


def pyramid_of(ctx, counts) -> dict:
    """The pyramid of the pool pair with (source, target) `counts`."""
    key = (ctx.seed, tuple(int(c) for c in counts))
    if key not in _CACHE:
        pool = pools.request_pool(ctx.seed, ctx.traffic)
        src, tgt = next((s, t) for s, t in pool if (len(s), len(t)) == key[1])
        _CACHE[key] = pair_pyramid(ctx.ref_cfg, tgt, src)
    return _CACHE[key]


def _linear(rows: int, din: int, dout: int) -> float:
    return 2.0 * rows * din * dout


def _kpconv(queries: int, entries: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * k * entries * cin + 2.0 * queries * k * cin * cout


def backbone_flops(cfg, pyr: dict) -> float:
    """The KPConv-FPN's products at the pyramid's sizes (both clouds)."""
    n = [a + b for a, b in pyr["lengths"]]
    nb, sub = pyr["neighbors"], pyr["subsampling"]
    d, k = cfg.init_dim, cfg.kernel_size
    total = _kpconv(n[0], nb[0], k, 1, d)  # encoder1_1
    # (support stage, query stage, valid entries, in, out) of each residual block
    blocks = [(0, 0, nb[0], d, 2 * d), (0, 1, sub[0], 2 * d, 2 * d),
              (1, 1, nb[1], 2 * d, 4 * d), (1, 1, nb[1], 4 * d, 4 * d),
              (1, 2, sub[1], 4 * d, 4 * d), (2, 2, nb[2], 4 * d, 8 * d),
              (2, 2, nb[2], 8 * d, 8 * d), (2, 3, sub[2], 8 * d, 8 * d),
              (3, 3, nb[3], 8 * d, 16 * d), (3, 3, nb[3], 16 * d, 16 * d)]
    for s_stage, q_stage, entries, cin, cout in blocks:
        mid = cout // 4
        if cin != mid:
            total += _linear(n[s_stage], cin, mid)
        total += _kpconv(n[q_stage], entries, k, mid, mid) + _linear(n[q_stage], mid, cout)
        if cin != cout:
            total += _linear(n[q_stage], cin, cout)
    total += _linear(n[2], 24 * d, 8 * d) + _linear(n[1], 12 * d, cfg.output_dim)
    return total


def transformer_flops(cfg, nr: int, ns: int) -> float:
    d, h = WIDTH, cfg.num_heads
    total = 0.0
    for n in (nr, ns):
        total += 2 * 2.0 * n * n * 3  # distances for the embedding and its angle neighbours
        total += _linear(n * n, d, d) + _linear(3 * n * n, d, d)  # proj_d, proj_a
        total += _linear(n, cfg.transformer_input_dim, d) + _linear(n, d, d)  # in, out proj
    for block in cfg.transformer_architecture:
        if block == "self":
            for n in (nr, ns):
                total += 3 * _linear(n, d, d) + 2.0 * n * d * d  # q, k, v; q W_p
                total += 2.0 * n * n * d + 2.0 * n * n * h * d + 2.0 * n * n * d  # qk, qWp.e, Av
                total += _linear(n, d, d) + _linear(n, d, 2 * d) + _linear(n, 2 * d, d)
        else:
            for nq, nk in ((nr, ns), (ns, nr)):
                total += _linear(nq, d, d) + 2 * _linear(nk, d, d)
                total += 2 * 2.0 * nq * nk * d
                total += _linear(nq, d, d) + _linear(nq, d, 2 * d) + _linear(nq, 2 * d, d)
    return total


def search_flops(pyr: dict, num_stages: int) -> float:
    """The radius searches' distance products (every query against every
    key of its cloud, as the kNN kernel computes them)."""
    lens = pyr["lengths"]
    pairs = [(s, s) for s in range(num_stages)]
    pairs += [(s + 1, s) for s in range(num_stages - 1)]
    pairs += [(s, s + 1) for s in range(1, num_stages - 1)]
    return sum(2.0 * lens[q][i] * lens[k][i] * 3 for q, k in pairs for i in range(2))


def patches(cfg, pyr: dict) -> int:
    nr, ns = pyr["lengths"][-1]
    return min(cfg.num_est_coarse_corr, nr * ns)


def request_flops(ctx, counts) -> float:
    cfg = ctx.ref_cfg
    pyr = pyramid_of(ctx, counts)
    (fr, fs), (nr, ns) = pyr["lengths"][1], pyr["lengths"][-1]
    k = cfg.point_per_patch
    return (search_flops(pyr, cfg.num_stages) + backbone_flops(cfg, pyr)
            + transformer_flops(cfg, nr, ns)
            + 2.0 * (nr * fr + ns * fs) * 3  # partition distances
            + 2.0 * nr * ns * WIDTH  # coarse matching
            + 2.0 * patches(cfg, pyr) * k * k * WIDTH)  # OT scores


def rpe_hidden_work(n: int, d: int, h: int) -> Dict[str, float]:
    """The RPE attention's work for hidden states alone: reads q, k, v,
    q W_p, the key mask and the fp32 (N, N, D) embedding, writes (N, D);
    products q.k, (q W_p).e and A v; one softmax."""
    return {"bytes": n * n * d * 4 + (3 * n * d + n * h * d + n) * 4 + n * d * 4,
            "products": 2.0 * (2 * n * n * d + n * n * h * d),
            "other": 4.0 * h * n * n}


def bound_s(kernel: str, part: dict) -> float:
    if kernel != "rpe_attention":
        return roofline.bound_s(kernel, part)
    w = rpe_hidden_work(**part)
    return max(w["bytes"] / roofline.HBM_BYTES_PER_S, w["products"] / roofline.TENSOR_FLOP_PER_S,
               w["other"] / roofline.FP32_FLOP_PER_S)


def launches(ctx, counts) -> Dict[str, List[dict]]:
    """One request's launches of the three shared kernels, a part each."""
    cfg = ctx.ref_cfg
    pyr = pyramid_of(ctx, counts)
    nodes = pyr["lengths"][-1]
    blocks = tuple(cfg.transformer_architecture).count("self")
    k1 = cfg.point_per_patch + 1
    return {"geo_embedding": [{"r": n * n, "k": 3, "h": WIDTH, "out_bytes": 4} for n in nodes],
            "rpe_attention": [{"n": n, "d": WIDTH, "h": cfg.num_heads} for n in nodes] * blocks,
            "sinkhorn": [{"p": patches(cfg, pyr), "m1": k1, "n1": k1, "t": cfg.sinkhorn_iters}]}


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    """The launches' bound at the profiled requests' sizes over the
    kernel's device time there; nothing when it did not run there or ran
    another number of launches than those requests give."""
    t = run.trace
    if t is None or not t["kernel_s"].get(kernel) or not t["launches"].get(kernel):
        return None
    shapes = [p for counts in t["counts"] for p in launches(run.ctx, counts)[kernel]]
    if t["launches"][kernel] != len(shapes):
        return None
    return 100.0 * sum(bound_s(kernel, p) for p in shapes) / t["kernel_s"][kernel]


def mfu_pct(run) -> Optional[float]:
    """Required products of the requests outside the profiled and lapped
    stretches over their wall time, over the dense tensor-core peak."""
    plain = [r for r in run.records if not r[3]]
    if not plain:
        return None
    work = sum(request_flops(run.ctx, counts) for r in plain for counts in r[4])
    secs = sum(r[1] - r[0] for r in plain)
    return 100.0 * work / secs / (run.ctx.entry["chips"] * roofline.TENSOR_FLOP_PER_S)

