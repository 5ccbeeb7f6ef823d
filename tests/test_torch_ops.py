"""Port ops against the JAX package's ops: geometry, neighbors, FPS,
partition and the tie order of top-k (CPU, fp32).

Continuous outputs within rtol 1e-4 / atol 1e-5; discrete outputs (kNN and
FPS indices, partitions, top-k indices) exactly, on tie-free inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.ops import geometry as tg
from roitr_torch.ops import neighbors as tn
from roitr_torch.ops.fps import furthest_point_sampling, num_valid_samples
from roitr_torch.ops.partition import point_to_node_partition
from roitr_torch.ops.topk import topk
from roitr_tpu.ops import fps as jf
from roitr_tpu.ops import geometry as jg
from roitr_tpu.ops import neighbors as jn
from roitr_tpu.ops import partition as jp

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, n, count):
    pts = np.zeros((n, 3), np.float32)
    pts[:count] = rng.rand(count, 3).astype(np.float32)
    return pts


def test_pairwise_sq_dist_and_masks(rng):
    x = rng.randn(37, 3).astype(np.float32)
    y = rng.randn(29, 3).astype(np.float32)
    np.testing.assert_allclose(tg.pairwise_sq_dist(_t(x), _t(y)).numpy(),
                               np.asarray(jg.pairwise_sq_dist(x, y)), **TOL)
    u = x / np.linalg.norm(x, axis=1, keepdims=True)
    np.testing.assert_allclose(tg.pairwise_sq_dist(_t(u), _t(u), normalized=True).numpy(),
                               np.asarray(jg.pairwise_sq_dist(u, u, normalized=True)), **TOL)
    xm, ym = rng.rand(37) > 0.3, rng.rand(29) > 0.3
    got = tg.masked_pairwise_sq_dist(_t(x), _t(y), _t(xm), _t(ym)).numpy()
    want = np.asarray(jg.masked_pairwise_sq_dist(x, y, jnp.asarray(xm), jnp.asarray(ym)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(tg.prefix_mask(10, torch.tensor(4)).numpy(),
                                  np.asarray(jg.prefix_mask(10, 4)))
    idx = rng.randint(0, 10, (5, 3))
    np.testing.assert_array_equal(tg.index_valid(_t(idx), torch.tensor(6)).numpy(),
                                  np.asarray(jg.index_valid(jnp.asarray(idx), 6, 10)))


def test_calc_ppf(rng):
    p = rng.randn(20, 3).astype(np.float32)
    n = rng.randn(20, 3).astype(np.float32)
    gp = rng.randn(20, 6, 3).astype(np.float32)
    gn = rng.randn(20, 6, 3).astype(np.float32)
    np.testing.assert_allclose(tg.calc_ppf(_t(p), _t(n), _t(gp), _t(gn)).numpy(),
                               np.asarray(jg.calc_ppf(p, n, gp, gn)), **TOL)


@pytest.mark.parametrize("count,k,exclude_self", [
    (300, 16, True), (300, 8, False), (12, 16, True), (5, 16, True)])
def test_masked_knn_indices_exact(rng, count, k, exclude_self):
    """Including the phantom-neighbor padding (count < k + 1: the trailing
    slots are point 0 and stay valid neighbors)."""
    keys = _cloud(rng, 320, count)
    queries = keys if exclude_self else rng.rand(90, 3).astype(np.float32)
    idx, d = tn.masked_knn(_t(queries), _t(keys), torch.tensor(count), k,
                           exclude_self=exclude_self)
    jidx, jd = jn.masked_knn(queries, keys, count, k, exclude_self=exclude_self)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)


def test_masked_knn_query_tiles_agree(rng, monkeypatch):
    keys = _cloud(rng, 256, 240)
    one, _ = tn.masked_knn(_t(keys), _t(keys), torch.tensor(240), 8, exclude_self=True)
    monkeypatch.setattr(tn, "_TILE_ELEMS", 256 * 7)  # 7-query tiles, ragged last tile
    tiled, _ = tn.masked_knn(_t(keys), _t(keys), torch.tensor(240), 8, exclude_self=True)
    np.testing.assert_array_equal(one.numpy(), tiled.numpy())


def test_three_nn_interpolate(rng):
    parent = rng.rand(128, 3).astype(np.float32)
    child = _cloud(rng, 64, 50)
    feats = rng.randn(64, 8).astype(np.float32)
    got = tn.three_nn_interpolate(_t(parent), _t(child), _t(feats), torch.tensor(50)).numpy()
    want = np.asarray(jn.three_nn_interpolate(parent, child, feats, 50))
    np.testing.assert_allclose(got, want, **TOL)


def test_topk_tie_order_matches_lax_top_k():
    import jax

    v = np.array([[0.5, 1.0, 1.0, 0.0, 1.0, 0.0, -2.0, 0.0]], np.float32)
    for k in (1, 3, 6):
        vals, idx = topk(_t(v), k)
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        _, low = topk(_t(v), k, largest=False)
        _, jlow = jax.lax.top_k(-jnp.asarray(v), k)
        np.testing.assert_array_equal(low.numpy(), np.asarray(jlow))


@pytest.mark.parametrize("n,counts,m", [(512, (500, 437), 128), (256, (40, 256), 64),
                                        (192, (3, 100), 48)])
def test_fps_matches_jax_exactly(rng, n, counts, m):
    """Batched over two clouds; a cloud with fewer valid points than
    samples repeats the seed in its surplus slots."""
    pts = np.stack([_cloud(rng, n, c) for c in counts])
    got = furthest_point_sampling(_t(pts), torch.tensor(counts), m).numpy()
    for b, c in enumerate(counts):
        np.testing.assert_array_equal(got[b], np.asarray(jf.furthest_point_sampling(pts[b], c, m)))
    np.testing.assert_array_equal(num_valid_samples(torch.tensor(counts), 4).numpy(),
                                  np.asarray(jf.num_valid_samples(jnp.asarray(counts), 4)))


@pytest.mark.parametrize("point_count,node_count,limit", [(230, 6, 16), (256, 8, 64), (100, 3, 8)])
def test_point_to_node_partition_exact(rng, point_count, node_count, limit):
    pts = _cloud(rng, 256, point_count)
    nodes = _cloud(rng, 8, node_count)
    got = point_to_node_partition(_t(pts), _t(nodes), limit, torch.tensor(point_count),
                                  torch.tensor(node_count))
    want = jp.point_to_node_partition(pts, nodes, limit, point_count, node_count)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
