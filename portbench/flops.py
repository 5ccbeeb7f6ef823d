"""The products (matrix multiplications, 2 operations a multiply-add) that
RoITr's equations require for one request and for one training step of
one pair, from the configuration and the pair's valid point counts.

Each term is one product of the reference (portbench/reference), at the
sizes the pair's inputs need rather than the padded bucket: a cloud's
`count` points and count // stride valid samples a level
(roofline.level_sizes), so that padding is no work. The terms: every
Linear layer, the exact kNN's and the partition's distance products
(x^2 - 2xy + y^2), the geometric embedding's projections, the attention
products, the OT scores and the loss terms. A training step adds the
backward: each product again for every operand that needs a gradient
(weights always; inputs unless they are data, such as the point-pair
features and the sinusoidal bases). Products of 3x3
matrices (normals' PCA, rigid transforms) are left out: they are under a
thousandth of the whole.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.roofline import level_sizes

# (flops, how many times the backward repeats it: 0 no gradient, 1 the
# weight's only, 2 the weight's and the input's)
Term = Tuple[float, int]


def _linear(rows: int, din: int, dout: int, data_input: bool = False) -> Term:
    return (2.0 * rows * din * dout, 1 if data_input else 2)


def _dist(q: int, n: int, c: int = 3, grad: int = 0) -> Term:
    return (2.0 * q * n * c, grad)


def _local(m: int, n_in: int, k: int, din: int, hid: int, dout: int,
           data_input: bool = False) -> List[Term]:
    """A local PPF transformer: M centres with K neighbours among N_in
    points of width din."""
    return [
        _linear(m * k, 4, hid, data_input=True),  # PPF embedding
        _linear(n_in, din, hid, data_input=data_input),  # in_proj
        *[_linear(n_in, hid, hid)] * 3,  # q, k, v over every point
        *[_linear(m * k, hid, hid)] * 2,  # p, vp over the neighbourhoods
        _linear(m, hid, hid),  # linear
        _linear(m, hid, dout),  # out_proj
    ]


def _cloud(cfg, count: int) -> List[Term]:
    """Encoder and decoder of one cloud of `count` valid points."""
    f = 1 if cfg.benchmark in ("3DMatch", "3DLoMatch") else 2
    planes = [64 * f, 128 * f, 256 * f, 256 * f]
    sizes = level_sizes(cfg, count)
    terms: List[Term] = []
    prev_n, din = count, 1
    for lvl in range(4):
        m, p, k = sizes[lvl], planes[lvl], cfg.enc_nsample[lvl]
        terms.append(_dist(m, prev_n))  # cross kNN
        terms += _local(m, prev_n, k, din, p, p, data_input=lvl == 0)
        terms.append(_dist(m, m))  # self kNN
        for _ in range(1, cfg.enc_blocks[lvl]):
            terms += _local(m, m, k, p, p, p)
        prev_n, din = m, p
    # decoder: the head at the coarsest level, then three upsamplings
    n4, p4 = sizes[3], planes[3]
    terms += [_linear(1, p4, p4), _linear(n4, 2 * p4, p4)]
    terms += _local(n4, n4, cfg.enc_nsample[3], p4, p4, p4)
    for lvl in (2, 1, 0):
        m, p, k = sizes[lvl], planes[lvl], cfg.enc_nsample[lvl]
        terms += [_linear(sizes[lvl + 1], planes[lvl + 1], p), _dist(m, sizes[lvl + 1]),
                  _linear(m, p, p)]
        terms += _local(m, m, k, p, p, p)
    terms.append(_linear(count, 64 * f, 256 * f))  # fine_proj
    return terms


def _global(cfg, ns: int, nt: int) -> List[Term]:
    """The geometric transformer over the clouds' ns and nt valid nodes."""
    f = 1 if cfg.benchmark in ("3DMatch", "3DLoMatch") else 2
    d, h = 256 * f, cfg.num_heads
    terms: List[Term] = []
    for n in (ns, nt):  # each cloud's embedding
        nn = n * n
        terms += [_dist(n, n), _dist(n, n), _linear(nn, d, d, data_input=True),
                  _linear(nn * 3, d, d, data_input=True)]
    terms += [_linear(ns, d, d), _linear(nt, d, d)]  # in_proj
    for block in cfg.transformer_architecture:
        if block == "self":
            for n in (ns, nt):  # each cloud over itself
                nn = n * n
                terms += [_linear(n, d, d)] * 3  # q, k, v
                terms += [(2.0 * n * d * d, 2),  # q W_p
                          (2.0 * nn * d, 2), (2.0 * nn * h * d, 2),  # q.k, qW_p.e
                          (2.0 * nn * d, 2), (2.0 * nn * h * d, 2),  # A v, A' e
                          (2.0 * n * d * d, 2)]  # proj_vp of A' e
                terms += [_linear(n, d, d)] * 2  # linear, pos_linear
                terms += [_linear(n, d, 2 * d), _linear(n, 2 * d, d)] * 2  # two FFNs
        else:
            for nq, nk in ((ns, nt), (nt, ns)):  # both directions: queries, keys
                terms += [_linear(nq, d, d), _linear(nk, d, d), _linear(nk, d, d)]
                terms += [(2.0 * nq * nk * d, 2), (2.0 * nq * nk * d, 2)]  # q.k, A v
                terms += [_linear(nq, d, d), _linear(nq, d, 2 * d), _linear(nq, 2 * d, d)]
    terms += [_linear(ns, d, d), _linear(nt, d, d)]  # out_proj
    terms += [_linear(ns, d, d), _linear(nt, d, d)]  # coarse_proj
    return terms


def _terms(cfg, counts, train: bool) -> List[Term]:
    f = 1 if cfg.benchmark in ("3DMatch", "3DLoMatch") else 2
    c = 256 * f
    cs, ct = (int(x) for x in counts)
    ns, nt = level_sizes(cfg, cs)[-1], level_sizes(cfg, ct)[-1]
    k = cfg.point_per_patch
    terms = _cloud(cfg, cs) + _cloud(cfg, ct) + _global(cfg, ns, nt)
    terms += [_dist(ns, cs), _dist(nt, ct)]  # partition
    terms.append(_dist(ns, nt, c))  # coarse matching
    if train:
        p = min(cfg.num_gt_coarse_corr, cfg.max_gt_corr_candidates, ns * nt)
        terms.append(_dist(ns, nt))  # ground-truth node overlaps
        terms.append(_dist(ns, nt, c, grad=2))  # coarse loss
        terms.append(_dist(p * k, k))  # fine loss: point distances in each patch
    else:
        p = min(ns * nt, cfg.num_est_coarse_corr if f == 1
                else cfg.coarse_corr_capacity or max(4 * cfg.num_est_coarse_corr, 512))
        for n in (cs, ct):  # the normals' kNN and covariances, one a cloud
            terms += [_dist(n, n), (2.0 * n * 3 * cfg.normal_knn * 3, 0)]
    terms.append((2.0 * p * k * k * c, 2))  # OT scores
    return terms


def request_flops(cfg, counts) -> float:
    """Products of one request of a pair with `counts` = (source, target)
    valid points: device normals and the forward."""
    return sum(fl for fl, _ in _terms(cfg, counts, train=False))


def train_step_flops(cfg, counts) -> float:
    """Products of one training step of one pair with `counts` valid
    points: the forward with ground truth and the losses, and the
    backward."""
    return sum(fl * (1 + rep) for fl, rep in _terms(cfg, counts, train=True))
