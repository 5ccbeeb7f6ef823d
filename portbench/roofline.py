"""The H100's published peaks and the least time the seven kernels' work
can take on it.

A kernel's bound is the largest of three times, each from the work its
launch's shapes require, whatever implements it:

- bytes over the HBM rate: each input read once and each output written
  once (what an implementation keeps beside the result for its own
  backward, such as an argmax map, a trajectory or log-sum-exps, is not
  part of the work);
- products over the dense tensor-core rate, counted as the multiply-adds
  the equations require at fp32 accuracy (two operations each), however
  many passes an implementation makes for them;
- other arithmetic over the fp32 rate outside the tensor cores, each exp,
  log, sin and cos counted as one operation.

Shapes are what the pair's inputs need, not the padded buckets the
program launches at: FPS picks count // stride points among a cloud's
`count` valid ones at each level, and the geometric embedding and the
attention run over the count // 64 valid nodes of each cloud (their
squares for the (N, N) terms), so a kernel that skips the padding's work
still reads under 100%. A launch may hold parts of different sizes (FPS
takes both clouds in one); its bound is that of the parts' summed work.
Sinkhorn runs the configured 100 iterations over the configuration's
number of patches of point_per_patch + 1 rows and columns.
"""

from __future__ import annotations

from typing import Dict, List

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOP_PER_S = 989e12  # bf16 / fp16 dense: the fastest product rate used here
FP32_FLOP_PER_S = 67e12  # fp32 outside the tensor cores

# the CUDA functions of each kernel of the port (csrc/*.cu), by name
KERNEL_FUNCTIONS = {
    "fps": ("fps_kernel",),
    "geo_embedding": ("geo_embedding_kernel", "geo_embedding_split_weights"),
    "geo_embedding_bwd": ("geo_embedding_bwd_kernel", "geo_embedding_bwd_reduce"),
    "rpe_attention": ("rpe_attention_kernel",),
    "rpe_attention_bwd": ("rpe_attention_bwd_rows", "rpe_products", "rpe_sum_splits"),
    "sinkhorn": ("sinkhorn_lines_fwd", "sinkhorn_kernel"),
    "sinkhorn_bwd": ("sinkhorn_lines_bwd", "sinkhorn_bwd_kernel"),
}


def work(kernel: str, **s) -> Dict[str, float]:
    """{"bytes", "products" (flops), "other" (ops)} of one launch."""
    if kernel == "fps":  # B clouds of n points, m picks: distance, min, argmax a point a pick
        b, n, m = s["b"], s["n"], s["m"]
        return {"bytes": b * n * 12 + b * 4 + b * m * 4, "products": 0.0,
                "other": 10.0 * b * (m - 1) * n}
    if kernel == "geo_embedding":  # R rows, k angles, width H, fp32 out
        r, k, h = s["r"], s["k"], s["h"]
        return {"bytes": r * 4 * (1 + k) + 2 * (h * h + h) * 4 + r * h * s.get("out_bytes", 4),
                "products": 2.0 * r * (1 + k) * h * h,
                # omega (H/2 a value), sin and cos (H), max over k and two bias adds
                "other": r * (1 + k) * 1.5 * h + r * h * (k + 1)}
    if kernel == "geo_embedding_bwd":  # dWd and dWa (the winning angle a column) from g
        r, k, h = s["r"], s["k"], s["h"]
        return {"bytes": r * 4 * (1 + k) + r * h * s.get("g_bytes", 4) + 2 * (h * h + h) * 4,
                "products": 4.0 * r * h * h,
                "other": r * (1 + k) * 1.5 * h + 2 * r * h}
    if kernel == "rpe_attention":  # N nodes, width D, H heads
        n, d, h = s["n"], s["d"], s["h"]
        e = n * n * d * s.get("e_bytes", 4)
        return {"bytes": e + (3 * n * d + n * h * d + n) * 4 + (n * d + n * h * d) * 4,
                # q.k, qWp.e, A v, A' e
                "products": 2.0 * (2 * n * n * d + 2 * n * n * h * d),
                # two softmaxes: scale, exp, sum, divide
                "other": 2 * 4.0 * h * n * n}
    if kernel == "rpe_attention_bwd":
        n, d, h = s["n"], s["d"], s["h"]
        e = n * n * d * s.get("e_bytes", 4)
        return {"bytes": 2 * e + (3 * n * d + n * h * d + n) * 4 + (n * d + n * h * d) * 4
                + (3 * n * d + n * h * d) * 4,
                # the scores again (q.k, qWp.e), then dv, dA, dq, dk, dqWp, de from the
                # value softmax and dA', de from the positional one
                "products": 2.0 * (5 * n * n * d + 5 * n * n * h * d),
                "other": 2 * 6.0 * h * n * n}
    if kernel == "sinkhorn":  # P patches of (M1, N1), T iterations, log domain
        p, m1, n1, t = s["p"], s["m1"], s["n1"], s["t"]
        return {"bytes": 2 * p * m1 * n1 * 4 + p * (m1 + n1) * 4, "products": 0.0,
                # a half-step: add the potential, exp, accumulate; a log a line
                "other": p * t * (2 * 3.0 * m1 * n1 + (m1 + n1)) + 2.0 * p * m1 * n1}
    if kernel == "sinkhorn_bwd":
        p, m1, n1, t = s["p"], s["m1"], s["n1"], s["t"]
        return {"bytes": 3 * p * m1 * n1 * 4 + p * (m1 + n1) * 4, "products": 0.0,
                # a half-step: two adds and an exp for the weights, a product and a sum
                "other": p * t * 2 * 5.0 * m1 * n1}
    raise KeyError(kernel)


def bound_s(kernel: str, *parts: dict) -> float:
    """The least time of one launch that does the work of all its parts."""
    w = {key: sum(work(kernel, **p)[key] for p in parts) for key in ("bytes", "products", "other")}
    return max(w["bytes"] / HBM_BYTES_PER_S, w["products"] / TENSOR_FLOP_PER_S,
               w["other"] / FP32_FLOP_PER_S)


def level_sizes(cfg, count: int) -> List[int]:
    """A cloud's valid points at each encoder level, from its count (a
    stride of 1 keeps them; at least one a level, as the program's
    num_valid_samples)."""
    sizes, n = [], int(count)
    for s in cfg.enc_strides:
        n = max(n // s, 1)
        sizes.append(n)
    return sizes


def launches(cfg, counts, train: bool) -> Dict[str, List[List[dict]]]:
    """The launches of each kernel in one request (train False) or one
    training step of one pair (train True) whose clouds hold `counts` =
    (source, target) valid points: each launch a list of parts, each part
    the shapes that `work` takes."""
    factor = 1 if cfg.benchmark in ("3DMatch", "3DLoMatch") else 2
    width = 256 * factor
    levels = [[int(c)] + level_sizes(cfg, c) for c in counts]
    fps = [[{"b": 1, "n": lv[i], "m": lv[i + 1]} for lv in levels]
           for i, s in enumerate(cfg.enc_strides) if s != 1]
    nodes = [lv[-1] for lv in levels]
    blocks = tuple(cfg.transformer_architecture).count("self")
    e_bytes = 2 if cfg.geo_embedding_storage == "bf16" else 4
    geo = [[{"r": n * n, "k": 3, "h": width, "out_bytes": e_bytes}] for n in nodes]
    rpe = [[{"n": n, "d": width, "h": cfg.num_heads, "e_bytes": e_bytes}] for n in nodes] * blocks
    if train:
        patches = min(cfg.num_gt_coarse_corr, cfg.max_gt_corr_candidates)
    elif factor == 1:
        patches = cfg.num_est_coarse_corr
    else:
        patches = cfg.coarse_corr_capacity or max(4 * cfg.num_est_coarse_corr, 512)
    patches = min(patches, nodes[0] * nodes[1])
    k1 = cfg.point_per_patch + 1
    ot = [[{"p": patches, "m1": k1, "n1": k1, "t": cfg.sinkhorn_iters}]]
    out = {"fps": fps, "geo_embedding": geo, "rpe_attention": rpe, "sinkhorn": ot}
    if train:
        geo_bwd = [[{"r": n * n, "k": 3, "h": width, "g_bytes": e_bytes}] for n in nodes]
        out.update(sinkhorn_bwd=ot, rpe_attention_bwd=rpe, geo_embedding_bwd=geo_bwd)
    return out
