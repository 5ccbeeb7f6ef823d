"""Each kernel's bytes and operations against shapes worked by hand, the
peaks, and the launches of a request and of a training step."""

import types

import pytest

from portbench import roofline


def test_fps_work():
    # 2 clouds of 8 points, 2 picks: 96 + 2 count bytes... coordinates, counts, picks
    w = roofline.work("fps", b=2, n=8, m=2)
    assert w == {"bytes": 2 * 8 * 12 + 2 * 4 + 2 * 2 * 4, "products": 0.0, "other": 10.0 * 2 * 1 * 8}


def test_geo_embedding_work():
    w = roofline.work("geo_embedding", r=4, k=3, h=2, out_bytes=4)
    # inputs 4 distances and 12 angles, two 2x2 weights and biases; 4x2 fp32 out
    assert w["bytes"] == 4 * 4 + 12 * 4 + 2 * (4 + 2) * 4 + 4 * 2 * 4
    # (1 + 3) basis rows of width 2 times a 2x2 weight, for 4 rows
    assert w["products"] == 2.0 * 4 * 4 * 2 * 2
    assert w["other"] == 4 * 4 * 3 + 4 * 2 * 4
    g = roofline.work("geo_embedding_bwd", r=4, k=3, h=2, g_bytes=2)
    assert g["bytes"] == 4 * 4 + 12 * 4 + 4 * 2 * 2 + 2 * (4 + 2) * 4
    assert g["products"] == 4.0 * 4 * 2 * 2


def test_rpe_attention_work():
    n, d, h = 2, 4, 2
    w = roofline.work("rpe_attention", n=n, d=d, h=h, e_bytes=2)
    # embedding 2x2x4 bf16; q, k, v 2x4, qWp 2x2x4, mask 2; hidden 2x4, ae 2x2x4
    assert w["bytes"] == 16 * 2 + (24 + 16 + 2) * 4 + (8 + 16) * 4
    # q.k and A v: 2*2*4 each; qWp.e and A'e: 2*2*2*4 each
    assert w["products"] == 2.0 * (16 + 16 + 32 + 32)
    b = roofline.work("rpe_attention_bwd", n=n, d=d, h=h, e_bytes=4)
    assert b["products"] == 2.0 * (5 * 16 + 5 * 32)
    assert b["bytes"] == 2 * 64 + (24 + 16 + 2) * 4 + (8 + 16) * 4 + (24 + 16) * 4


def test_sinkhorn_work():
    w = roofline.work("sinkhorn", p=1, m1=2, n1=3, t=1)
    assert w == {"bytes": 2 * 6 * 4 + 5 * 4, "products": 0.0, "other": 2 * 3 * 6 + 5 + 2 * 6}
    b = roofline.work("sinkhorn_bwd", p=1, m1=2, n1=3, t=2)
    assert b["other"] == 2 * 2 * 5 * 6


def test_bound_is_the_largest_term():
    w = roofline.work("rpe_attention", n=512, d=256, h=4, e_bytes=4)
    assert roofline.bound_s("rpe_attention", dict(n=512, d=256, h=4, e_bytes=4)) == pytest.approx(
        max(w["bytes"] / 3.35e12, w["products"] / 989e12, w["other"] / 67e12))


def test_a_launch_of_two_parts_is_bound_by_their_summed_work():
    # FPS of 20000 and 30000 valid points to 5000 and 7500 picks in one launch:
    # 10 operations a point a pick after the first, bytes 12 a point, 4 a count and a pick
    a, b = dict(b=1, n=20000, m=5000), dict(b=1, n=30000, m=7500)
    other = 10.0 * (4999 * 20000 + 7499 * 30000)
    byts = 20000 * 12 + 4 + 5000 * 4 + 30000 * 12 + 4 + 7500 * 4
    assert roofline.bound_s("fps", a, b) == pytest.approx(max(other / 67e12, byts / 3.35e12))
    assert roofline.bound_s("fps", a, b) == pytest.approx(other / 67e12)
    # a part bound by bytes and one by operations: the max of the sums, not the sum of maxes
    p, q = dict(p=1, m1=2, n1=3, t=0), dict(p=1, m1=2, n1=3, t=10 ** 6)
    wp, wq = roofline.work("sinkhorn", **p), roofline.work("sinkhorn", **q)
    assert roofline.bound_s("sinkhorn", p, q) == pytest.approx(max(
        (wp["bytes"] + wq["bytes"]) / 3.35e12, (wp["other"] + wq["other"]) / 67e12))


CFG = types.SimpleNamespace(benchmark="3DMatch", enc_strides=(1, 4, 4, 4), num_heads=4,
                            transformer_architecture=("self", "cross") * 3,
                            num_gt_coarse_corr=128, max_gt_corr_candidates=16384,
                            num_est_coarse_corr=256, coarse_corr_capacity=None,
                            point_per_patch=64, sinkhorn_iters=100,
                            geo_embedding_storage="fp32")


def test_launches_of_a_request_and_a_step():
    serve = roofline.launches(CFG, (32768, 32768), train=False)
    assert {k: len(v) for k, v in serve.items()} == {"fps": 3, "geo_embedding": 2,
                                                     "rpe_attention": 6, "sinkhorn": 1}
    assert [[part["m"] for part in launch] for launch in serve["fps"]] == [
        [8192, 8192], [2048, 2048], [512, 512]]
    assert serve["geo_embedding"][0] == [{"r": 512 * 512, "k": 3, "h": 256, "out_bytes": 4}]
    assert serve["sinkhorn"][0][0]["p"] == 256
    train = roofline.launches(CFG, (32768, 32768), train=True)
    assert {k: len(v) for k, v in train.items()} == {
        "fps": 3, "geo_embedding": 2, "rpe_attention": 6, "sinkhorn": 1, "sinkhorn_bwd": 1,
        "rpe_attention_bwd": 6, "geo_embedding_bwd": 2}
    assert train["sinkhorn"][0][0]["p"] == 128


def test_launches_at_uneven_valid_counts():
    """20000 and 30000 points in the 32768 bucket: FPS over the valid
    points of each level, the embedding and attention over 312 and 468
    valid nodes, not 512."""
    serve = roofline.launches(CFG, (20000, 30000), train=False)
    assert serve["fps"] == [
        [{"b": 1, "n": 20000, "m": 5000}, {"b": 1, "n": 30000, "m": 7500}],
        [{"b": 1, "n": 5000, "m": 1250}, {"b": 1, "n": 7500, "m": 1875}],
        [{"b": 1, "n": 1250, "m": 312}, {"b": 1, "n": 1875, "m": 468}]]
    assert [launch[0]["r"] for launch in serve["geo_embedding"]] == [312 ** 2, 468 ** 2]
    assert [launch[0]["n"] for launch in serve["rpe_attention"]] == [312, 468] * 3
    train = roofline.launches(CFG, (20000, 30000), train=True)
    assert [launch[0]["r"] for launch in train["geo_embedding_bwd"]] == [312 ** 2, 468 ** 2]
    assert [launch[0]["n"] for launch in train["rpe_attention_bwd"]] == [312, 468] * 3
    # the RPE backward at 312 nodes: 5 + 5 products of (312, 312) by 256 (and by 4 heads)
    part = train["rpe_attention_bwd"][0][0]
    assert roofline.work("rpe_attention_bwd", **part)["products"] == 2.0 * (
        5 * 312 * 312 * 256 + 5 * 312 * 312 * 4 * 256)
    # tiny clouds keep one node, as the program's num_valid_samples does
    assert roofline.launches(CFG, (3, 70), train=False)["rpe_attention"][:2] == [
        [{"n": 1, "d": 256, "h": 4, "e_bytes": 4}], [{"n": 1, "d": 256, "h": 4, "e_bytes": 4}]]
    assert roofline.launches(CFG, (3, 70), train=False)["sinkhorn"][0][0]["p"] == 1
