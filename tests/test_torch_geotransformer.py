"""GeoTransformer in the port (ops/grid.py, models/kpconv.py,
models/registration.py, models/geotransformer.py, `Matcher`) against the
benchmark's plain reference (portbench/reference/geotransformer.py), on
the CPU, on seeded weights (portbench/models/geotransformer.py) and small
synthetic pairs.

Tolerances: the grid's stages and the radius searches bit for bit (both
sides sort the same keys, sum barycentres in fp64 and round once, and the
searches share the tiled distance x^2 - 2xy + y^2); features within 1e-5
of the array's largest magnitude (the port contracts KPConv's kernel
points in one product, upstream in an einsum, and GroupNorm's statistics
are summed in another order); the registration within 1e-5 on the same
correspondences (batched Procrustes against upstream's padded chunks).
"""

import numpy as np
import pytest
import torch
from torch import nn

from portbench import pools
from portbench.models import geotransformer as bench_model
from portbench.reference import geotransformer as reference
from roitr_torch.config import Config
from roitr_torch.models import kpconv
from roitr_torch.models.registration import (inliers, local_to_global_registration,
                                             weighted_procrustes)
from roitr_torch.ops.grid import (GRID_SEARCHES, NUM_STAGES, build_grid_pyramid, by_cloud,
                                  radius_search)

SEED = 2200000123
VALUES = {"geo_embedding_storage": "fp32", "fine_matching_confidence_threshold": 0.0}


def _cfg(**kw) -> Config:
    return Config(model="geotransformer", **dict(VALUES, **kw))


def _ref_cfg(cfg: Config):
    # the reference reads the published stage count and transformer input
    # width, which the program fixes
    return reference.config(dict(vars(cfg), num_stages=NUM_STAGES,
                                 transformer_input_dim=16 * cfg.init_dim))


def _pair(points=(1800, 2200), index=1):
    """A synthetic surface pair of the benchmark's generator (src, tgt)."""
    return pools.request_pool(SEED, {"points": list(points), "pool": 2, "overlap": 0.7})[index]


def _stacked(tgt, src):
    return torch.from_numpy(np.concatenate([tgt, src])), (len(tgt), len(src))


def _close(got, want, frac=1e-5):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= frac * max(top, 1e-12)


@pytest.fixture(scope="module")
def state():
    return bench_model.make_state_dict(_ref_cfg(_cfg()), SEED, "cpu")


def test_grid_pyramid_matches_the_reference():
    cfg = _cfg()
    src, tgt = _pair()
    pyr = build_grid_pyramid(*_stacked(tgt, src), cfg)
    ref = reference.pyramid(_ref_cfg(cfg), tgt, src, "cpu")
    assert pyr.lengths == ref["lengths"]
    voxel = cfg.voxel_size
    for s in range(1, NUM_STAGES):
        voxel *= 2
        prev = pyr.points[s - 1].numpy()
        n0 = pyr.lengths[s - 1][0]
        for part, rows in ((prev[:n0], slice(0, pyr.lengths[s][0])),
                           (prev[n0:], slice(pyr.lengths[s][0], None))):
            voxels = np.unique(np.floor(part / np.float32(voxel)).astype(np.int64), axis=0)
            got = np.floor(pyr.points[s].numpy()[rows] / np.float32(voxel)).astype(np.int64)
            assert np.array_equal(np.unique(got, axis=0), voxels)  # one barycentre a voxel
        assert float((pyr.points[s] - ref["points"][s]).abs().max()) <= 1e-6
    for name in ("neighbors", "subsampling"):
        for got, want in zip(getattr(pyr, name), ref[name]):
            assert torch.equal(got, want), name
    for s in (1, 2):
        assert torch.equal(pyr.upsampling[s], ref["upsampling"][s])
    assert pyr.upsampling[0] is None and GRID_SEARCHES == 9


@pytest.mark.parametrize("limit", [38, 36])
def test_radius_search_limits_empty_rows_and_shadow(limit):
    rng = np.random.RandomState(limit)
    # a dense blob (rows past the limit), a sparse spread (rows with few),
    # and far points (rows with none), in two clouds of different sizes
    def cloud(n_dense, n_sparse, n_far):
        return np.concatenate([rng.rand(n_dense, 3) * 0.05, rng.rand(n_sparse, 3) * 2.0,
                               5.0 + rng.rand(n_far, 3) * 50.0]).astype(np.float32)

    keys = [cloud(120, 300, 6), cloud(60, 200, 3)]
    queries = [cloud(20, 40, 5), cloud(10, 30, 2)]
    radius = 0.0625
    k_all = torch.from_numpy(np.concatenate(keys))
    q_all = torch.from_numpy(np.concatenate(queries))
    q_len, k_len = (len(queries[0]), len(queries[1])), (len(keys[0]), len(keys[1]))
    got = radius_search(by_cloud(q_all, q_len), q_len, by_cloud(k_all, k_len), k_len, radius,
                        limit)
    want = reference.stacked_search([torch.from_numpy(q) for q in queries],
                                    [torch.from_numpy(k) for k in keys], radius, limit)
    assert torch.equal(got, want)
    shadow = len(k_all)
    found = (got != shadow).sum(dim=1)
    within = [int((np.linalg.norm(k - q, axis=1) < radius).sum())
              for qs, ks in zip(queries, keys) for q in qs for k in [ks]]
    assert max(within) > limit and int(found.max()) == limit  # rows cut at the limit
    assert int((found == 0).sum()) >= 7 and (got[found == 0] == shadow).all()  # rows with none
    assert torch.equal(found, torch.tensor(np.minimum(within, limit)))
    assert (got[:len(queries[0])][got[:len(queries[0])] != shadow] < len(keys[0])).all()
    assert (got[len(queries[0]):][got[len(queries[0]):] != shadow] >= len(keys[0])).all()


def _load(module, state, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
    return module


@pytest.mark.parametrize("name,strided", [("encoder1_1", False), ("encoder2_2", False),
                                          ("encoder2_1", True)])
def test_kpconv_blocks_match_the_reference(state, name, strided):
    cfg = _cfg()
    src, tgt = _pair()
    pyr = build_grid_pyramid(*_stacked(tgt, src), cfg)
    ref_net = reference.KPConvFPN(_ref_cfg(cfg))
    port_net = kpconv.KPConvFPN(1, cfg.output_dim, cfg.init_dim, cfg.kernel_size,
                                cfg.base_radius * cfg.voxel_size,
                                cfg.base_sigma * cfg.voxel_size, cfg.group_norm)
    ref_block = _load(getattr(ref_net, name), state, f"backbone.{name}.")
    port_block = _load(getattr(port_net, name), state, f"backbone.{name}.")
    assert getattr(port_block, "strided", False) == strided
    stage = {"encoder1_1": (0, 0, pyr.neighbors[0]), "encoder2_2": (1, 1, pyr.neighbors[1]),
             "encoder2_1": (1, 0, pyr.subsampling[0])}[name]
    q, s, idx = pyr.points[stage[0]], pyr.points[stage[1]], stage[2]
    cin = port_block.KPConv.weights.shape[2] if name == "encoder1_1" else (
        port_block.unary1.mlp.in_features)
    x = torch.randn((len(s), cin), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _close(port_block(x, q, s, idx), ref_block(x, q, s, idx))
        _close(port_block.KPConv(x[:, :port_block.KPConv.weights.shape[2]], q, s, idx),
               ref_block.KPConv(x[:, :port_block.KPConv.weights.shape[2]], q, s, idx))


def test_joint_group_norm_spans_both_clouds_and_skips_padding():
    gen = torch.Generator().manual_seed(5)
    norm = nn.GroupNorm(32, 64)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        norm.bias.copy_(torch.rand(64, generator=gen))
    a, b = torch.randn(300, 64, generator=gen) * 3, torch.randn(200, 64, generator=gen) + 2
    pad = torch.full((50, 64), 1e3)
    x = torch.cat([a, pad, b, pad[:20]])
    mask = torch.cat([torch.ones(300), torch.zeros(50), torch.ones(200), torch.zeros(20)]).bool()
    stacked = torch.cat([a, b])
    want = norm(stacked.t()[None])[0].t()
    with torch.no_grad():
        _close(kpconv.group_norm(x, norm, mask)[mask], want)
        _close(kpconv.group_norm(stacked, norm), want)
        per_cloud = torch.cat([norm(a.t()[None])[0].t(), norm(b.t()[None])[0].t()])
        assert float((per_cloud - want).abs().max()) > 0.1  # the statistics are joint


def test_kpconv_fpn_at_published_widths(state):
    cfg = _cfg()
    src, tgt = _pair((1900, 2100))
    pyr = build_grid_pyramid(*_stacked(tgt, src), cfg)
    ref_pyr = reference.pyramid(_ref_cfg(cfg), tgt, src, "cpu")
    port_net = _load(kpconv.KPConvFPN(1, 256, 64, 15, 0.0625, 0.05, 32), state, "backbone.")
    ref_net = _load(reference.KPConvFPN(_ref_cfg(cfg)), state, "backbone.")
    assert sum(p.numel() for p in port_net.parameters()) == sum(
        p.numel() for p in ref_net.parameters())
    ones = torch.ones((pyr.points[0].shape[0], 1))
    with torch.no_grad():
        fine, coarse = port_net(ones, pyr)
        ref_fine, ref_coarse = ref_net(ones, ref_pyr)
    assert fine.shape == (sum(pyr.lengths[1]), 256) and coarse.shape == (sum(pyr.lengths[3]),
                                                                         1024)
    _close(fine, ref_fine)
    _close(coarse, ref_coarse)


def _rigid(seed):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return torch.tensor(q, dtype=torch.float32), torch.tensor(rng.randn(3), dtype=torch.float32)


def _patches(seed, counts, reflect=False, length=12):
    """Correspondences in `len(counts)` patches of `length` rows (`counts`
    valid each): inliers of a rigid motion (or of a mirror image) with
    noise, half of every other patch's rows outliers. Returns the port's rows and the
    reference's (patch points, score and correspondence matrices)."""
    rng = np.random.RandomState(seed)
    rot, trans = _rigid(seed)
    p = len(counts)
    src = torch.tensor(rng.rand(p, length, 3) * 2.0, dtype=torch.float32)
    ref = src @ rot.T + trans
    if reflect:
        ref = ref * torch.tensor([1.0, 1.0, -1.0])
    ref = ref + torch.tensor(rng.randn(p, length, 3) * 0.01, dtype=torch.float32)
    out = torch.tensor((rng.rand(p, length) < 0.5) & (np.arange(p) % 2 == 1)[:, None])
    ref = torch.where(out[..., None], torch.tensor(rng.rand(p, length, 3) * 3.0,
                                                   dtype=torch.float32), ref)
    masks = torch.arange(length)[None, :] < torch.tensor(counts)[:, None]
    scores = torch.where(masks, torch.tensor(rng.rand(p, length) * 0.9 + 0.1,
                                             dtype=torch.float32), torch.zeros(()))
    score_mat = torch.diag_embed(scores)
    corr_mat = torch.diag_embed(masks)
    return (ref.reshape(-1, 3), src.reshape(-1, 3), scores.reshape(-1), masks.reshape(-1), p,
            (ref, src, score_mat, corr_mat), (rot, trans))


@pytest.mark.parametrize("case", ["hypotheses", "no_patch_of_three", "reflection"])
def test_local_to_global_registration_matches_the_reference(case):
    cfg = _cfg()
    counts = {"hypotheses": [12, 2, 7, 3, 0, 12, 9, 5],
              "no_patch_of_three": [2, 1, 2, 0, 2, 2, 1, 2],
              "reflection": [12, 12, 10, 8, 12, 6, 12, 11]}[case]
    ref, src, scores, masks, p, ref_args, (rot, trans) = _patches(7, counts, case == "reflection")
    got = local_to_global_registration(ref, src, scores, masks, p,
                                       cfg.fine_matching_correspondence_threshold,
                                       cfg.acceptance_radius, cfg.num_refinement_steps)
    want = reference.local_to_global(*ref_args, _ref_cfg(cfg))[3]
    _close(got, want)
    r = got[:3, :3].double()
    assert torch.allclose(r @ r.T, torch.eye(3, dtype=torch.float64), atol=1e-5)
    assert float(torch.linalg.det(r)) > 0.999
    if case == "hypotheses":
        assert torch.allclose(got[:3, :3], rot, atol=0.02) and torch.allclose(got[:3, 3], trans,
                                                                               atol=0.05)
    if case == "no_patch_of_three":
        # upstream's order: Procrustes over every correspondence, then each
        # of the refinement steps re-scores by its inliers and solves again
        step = weighted_procrustes(src[None], ref[None], scores[None])
        for _ in range(cfg.num_refinement_steps):
            hits = inliers(ref, src, masks, *step, cfg.acceptance_radius)[0]
            step = weighted_procrustes(src[None], ref[None], (scores * hits)[None])
        _close(got[:3, :3], step[0][0], 1e-6)
        _close(got[:3, 3], step[1][0], 1e-6)


def test_matcher_end_to_end_on_the_cpu(state):
    from portbench.drivers.geo_match import geo_numbers
    from roitr_torch.serving import Matcher

    cfg = _cfg()
    src, tgt = _pair((1900, 2100))
    matcher = Matcher(cfg, state, device="cpu", descriptors=True, prep="device")
    prog = matcher.match(src, tgt)
    ref_cfg = _ref_cfg(cfg)
    ref = reference.match(reference.build(ref_cfg, state, "cpu"), ref_cfg, src, tgt, "cpu")
    numbers = geo_numbers([prog], [ref], cfg.acceptance_radius)
    assert numbers["node_mismatch"] == 0.0
    assert numbers["desc_err"] < 1e-5
    assert numbers["corr_mismatch"] < 0.02
    assert numbers["conf_err"] < 1e-5
    assert prog["transform"].shape == (4, 4) and len(prog["confidence"]) > 0
    # the registration of the forward's own correspondences, laid out as the
    # reference's patches (row i of a patch against column i)
    with torch.no_grad():
        out = matcher.model(build_grid_pyramid(*_stacked(tgt, src), cfg))
    rows = cfg.point_per_patch * cfg.fine_matching_topk  # fine matching's rows a patch
    p = out["corr_masks"].numel() // rows
    shape = (p, rows)
    args = (out["tgt_corr_points"].reshape(p, rows, 3), out["src_corr_points"].reshape(p, rows, 3),
            torch.diag_embed(torch.where(out["corr_masks"], out["corr_scores"],
                                         torch.zeros(())).reshape(shape)),
            torch.diag_embed(out["corr_masks"].reshape(shape)))
    _close(out["transform"], reference.local_to_global(*args, ref_cfg)[3], 1e-4)
    np.testing.assert_allclose(prog["transform"], out["transform"].numpy())
    with pytest.raises(ValueError, match="prep='device'"):
        Matcher(cfg, state, device="cpu", prep="host")
    with pytest.raises(ValueError, match="RoITr only"):
        matcher.match_batch([(src, tgt)])
