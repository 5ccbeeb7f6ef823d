"""Host pyramids, device pyramids and segmented normals of the port against
the JAX package on the CPU, and the forward with a pyramid against the
forward without one.

- `build_cloud_pyramid` (roitr_torch/data/pyramid.py, the port's native
  library) equals JAX's (roitr_tpu/data/pyramid.py, its native library)
  bit for bit, at counts that leave short levels: fewer than nsample + 1
  points (phantom index-0 padding) and fewer than 3 keys (edge-padded
  3-NN).
- The native kNN and FPS equal the port's scipy path: indices exactly,
  upsampling weights within 1e-6 (float32 against float64 distances).
- `build_pyramids_packed` equals `pack_pyramids` of host pyramids (and the
  port's `pack_pyramids` JAX's): index fields exactly, weights within
  1e-5, except where the host puts a parent point at distance exactly 0
  from itself as a key while the device's x^2 - 2xy + y^2 distance leaves
  an fp32 residue (the weight of that key is then at least 0.95 on the
  device, 1 - O(1e-7) on the host). The JAX package's own device pyramid
  differs the same way and its forward with one matches its forward
  without (tests/test_pyramid.py).
- `estimate_normals_segmented` equals JAX's at rtol 1e-4 / atol 1e-5.
- The forward with host pyramids equals the forward without on every
  valid row: nodes and every index output exactly, node descriptors
  within rtol 1e-5 / atol 1e-6 (pad rows feed the rounding); point
  descriptors within 1e-3 (the same upsampling-weight residue); matching
  scores within 2e-3, the JAX twin test's bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch import native
from roitr_torch.config import Config
from roitr_torch.data.packing import attach_pyramids, pack_pairs, pack_pyramids
from roitr_torch.data.pyramid import CloudPyramid, build_cloud_pyramid
from roitr_torch.ops.normals import estimate_normals_segmented
from roitr_torch.ops.pyramid import build_pyramids_packed, device_prep_pair
from roitr_tpu.data.packing import pack_pyramids as jax_pack_pyramids
from roitr_tpu.data.pyramid import build_cloud_pyramid as jax_build_cloud_pyramid
from roitr_tpu.ops.normals import estimate_normals_segmented as jax_segmented

from torch_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_parity import pair_arrays, port_and_params, torch_pair

# (bucket, counts): full, short levels (level 4 of 256 // 64 = 4 rows with
# 1-3 points: fewer than 17 points and fewer than 3 keys), tiny clouds
CASES = [(256, (256, 230, 197)), (128, (128, 70, 66)), (64, (64, 9, 1))]


def _clouds(bucket, counts, seed=0):
    rng = np.random.RandomState(seed)
    clouds = []
    for c in counts:
        pts = np.zeros((bucket, 3), np.float32)
        pts[:c] = rng.randn(c, 3).astype(np.float32)
        clouds.append(pts)
    return clouds


@pytest.mark.parametrize("bucket,counts", CASES)
def test_host_pyramid_bit_equal_to_jax(bucket, counts):
    import roitr_tpu.native

    assert roitr_tpu.native.available()  # the JAX side runs its native library too
    for pts, c in zip(_clouds(bucket, counts), counts):
        got, want = build_cloud_pyramid(pts, c), jax_build_cloud_pyramid(pts, c)
        for name in CloudPyramid._fields:
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=f"count {c}: {name}")


@pytest.mark.parametrize("bucket,counts", CASES)
def test_native_equals_scipy_path(bucket, counts):
    for pts, c in zip(_clouds(bucket, counts, seed=1), counts):
        got = build_cloud_pyramid(pts, c)
        ref = build_cloud_pyramid(pts, c, backend="scipy")
        for name in CloudPyramid._fields:
            g, r = getattr(got, name), getattr(ref, name)
            if name.startswith("up_w"):
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(g, r, err_msg=name)


def test_native_knn_and_fps_equal_scipy():
    from scipy.spatial import cKDTree

    from roitr_torch.data.pyramid import _fps_host

    rng = np.random.RandomState(2)
    keys, queries = rng.rand(500, 3).astype(np.float32), rng.rand(300, 3).astype(np.float32)
    idx, dist = native.knn(keys, queries, 9)
    ref_d, ref_i = cKDTree(keys).query(queries, k=9)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_allclose(dist, ref_d, rtol=1e-6)
    idx, _ = native.knn(keys[:5], queries, 8)  # fewer keys than k: -1 past them
    assert (idx[:, 5:] == -1).all() and (idx[:, :5] >= 0).all()
    np.testing.assert_array_equal(_fps_host(keys, 64), _fps_host(keys, 64, backend="scipy"))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.build()
    with pytest.raises(ValueError, match="backend"):
        build_cloud_pyramid(np.zeros((64, 3), np.float32), 64, backend="jax")


@pytest.mark.parametrize("bucket,counts", CASES)
def test_device_pyramids_match_host(bucket, counts):
    clouds = _clouds(bucket, counts, seed=3)
    host_pyrs = [build_cloud_pyramid(p, c) for p, c in zip(clouds, counts)]
    host = pack_pyramids(host_pyrs)
    jax_host = jax_pack_pyramids(host_pyrs)
    dev = build_pyramids_packed(torch.from_numpy(np.concatenate(clouds)),
                                torch.tensor(counts))
    for name in CloudPyramid._fields:
        h, d = getattr(host, name), getattr(dev, name)
        assert h.shape == d.shape and h.dtype == d.dtype, name
        np.testing.assert_array_equal(h.numpy(), np.asarray(getattr(jax_host, name)),
                                      err_msg=name)
        if not name.startswith("up_w"):
            assert torch.equal(h, d), name
            continue
        # rows whose nearest key is the point itself at distance exactly 0
        # on the host (weight 1 up to 1e-7): the device keeps an fp32 residue
        self_key = h[:, 0] > 1 - 1e-6
        np.testing.assert_allclose(d[~self_key].numpy(), h[~self_key].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        assert (d[self_key, 0] >= 0.95).all(), name


def test_device_prep_pair_attaches_the_host_pyramid():
    cfg = Config(benchmark="3DMatch", normal_knn=9)
    pair = torch_pair(pair_arrays(4, 256, 230, 150))
    got = device_prep_pair(pair, cfg, est=(False, False), pyramid=True)
    want = attach_pyramids(pair, cfg.enc_strides, cfg.enc_nsample)
    for side in ("src_pyramid", "tgt_pyramid"):
        for name in CloudPyramid._fields:
            g, w = getattr(getattr(got, side), name), getattr(getattr(want, side), name)
            if not name.startswith("up_w"):
                assert torch.equal(g, w), (side, name)


def test_segmented_normals_match_jax():
    counts = (256, 200, 37)
    clouds = _clouds(256, counts, seed=4)
    flat = np.concatenate(clouds)
    got = estimate_normals_segmented(torch.from_numpy(flat), torch.tensor(counts), k=9)
    want = np.asarray(jax_segmented(jnp.asarray(flat), jnp.asarray(counts, jnp.int32), k=9))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    for b, c in enumerate(counts):  # pad rows zero, valid rows unit
        seg = got[b * 256:(b + 1) * 256]
        assert not seg[c:].any()
        np.testing.assert_allclose(seg[:c].norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_forward_with_host_pyramid_equals_forward_without():
    _, model, _, _ = port_and_params(0, geo_embedding_storage="fp32")
    cfg = model.cfg
    pair = torch_pair(pair_arrays(5, 256, 240, 190))
    with torch.no_grad():
        plain = model(pair, with_gt=True)
        with_pyr = model(attach_pyramids(pair, cfg.enc_strides, cfg.enc_nsample), with_gt=True)
    valid = {"src_nodes": "src_node_count", "tgt_nodes": "tgt_node_count",
             "src_node_feats": "src_node_count", "tgt_node_feats": "tgt_node_count",
             "src_point_feats": "src_count", "tgt_point_feats": "tgt_count"}
    for key, count in valid.items():
        n = int(plain[count])
        g, w = with_pyr[key][:n], plain[key][:n]
        if key.endswith("point_feats"):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=key)
        elif key.endswith("node_feats"):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=key)
        else:
            assert torch.equal(g, w), key
    for key in ("src_node_count", "tgt_node_count", "src_node_corr_indices",
                "tgt_node_corr_indices", "node_corr_masks", "gt_node_corr_indices",
                "gt_node_corr_masks", "src_node_corr_knn_masks", "tgt_node_corr_knn_masks"):
        assert torch.equal(with_pyr[key], plain[key]), key
    torch.testing.assert_close(with_pyr["matching_scores"], plain["matching_scores"], rtol=0,
                               atol=2e-3)


def test_packed_pair_needs_one_bucket_and_pyramids():
    a = torch_pair(pair_arrays(6, 256, 200, 180))
    b = torch_pair(pair_arrays(7, 128, 100, 90))
    with pytest.raises(ValueError, match="one shared src/tgt bucket"):
        pack_pairs([a, b], require_pyramids=False)
    with pytest.raises(ValueError, match="require host pyramids"):
        pack_pairs([a, a])
    packed = pack_pairs([a, a], require_pyramids=False)
    assert packed.src_pyramid is None and packed.src_count.tolist() == [200, 200]
