"""The port's device normals (roitr_torch/ops/normals.py) and device prep
(roitr_torch/ops/pyramid.py device_prep_pair) against the JAX package's on
the CPU, same seeded numpy inputs.

Tolerances: the closed-form smallest eigenvector within 1e-6 of JAX's,
element by element, on random and degenerate covariances (plane, line,
isotropic, zero); `estimate_normals` within a dot product of 0.99999 of
JAX's, both below k valid points and on a full cloud; against the host's
scipy normals (data/preprocess.py), dot > 0.999 on at least 98% of valid
points, the JAX package's own threshold (tests/test_ops_normals.py:77).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
from roitr_torch.data.synthetic import make_surface_cloud
from roitr_torch.ops.normals import _smallest_eigvec_3x3, estimate_normals
from roitr_torch.ops.pyramid import device_prep_pair
from roitr_tpu.ops.normals import _smallest_eigvec_3x3 as jax_eigvec
from roitr_tpu.ops.normals import estimate_normals as jax_estimate_normals
from roitr_tpu.ops.pyramid import device_prep_pair as jax_device_prep_pair

from torch_parity import jax_pair, pair_arrays, port_and_params, torch_pair


def _random_covs(seed, n=512):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 3, 3)
    cov = np.einsum("nij,nkj->nik", a, a) * 10.0 ** rng.uniform(-4, 2, size=(n, 1, 1))
    return cov.astype(np.float32)


def _degenerate_covs():
    rng = np.random.RandomState(1)
    q = np.linalg.qr(rng.randn(3, 3))[0]
    return np.stack([
        np.eye(3), np.zeros((3, 3)), np.diag([1.0, 1.0, 0.0]), np.diag([1.0, 0.0, 0.0]),
        q @ np.diag([2.0, 1.0, 1e-7]) @ q.T,  # a tilted plane
        q @ np.diag([3.0, 1e-6, 1e-6]) @ q.T,  # a tilted line
        np.full((3, 3), 1.0 / 3.0),  # rank one
    ]).astype(np.float32)


@pytest.mark.parametrize("covs", [_random_covs(0), _degenerate_covs()], ids=["random", "degenerate"])
def test_smallest_eigvec_matches_jax(covs):
    got = _smallest_eigvec_3x3(torch.from_numpy(covs)).numpy()
    want = np.asarray(jax_eigvec(jnp.asarray(covs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,count,k", [(64, 10, 33), (1024, 1000, 33)], ids=["below_k", "full"])
def test_estimate_normals_matches_jax(n, count, k):
    rng = np.random.RandomState(n)
    pts = np.zeros((n, 3), np.float32)
    # offset from the origin so that a pad row pulled into a neighbourhood
    # would visibly tilt the normals
    pts[:count] = make_surface_cloud(rng, count) + 3.0
    got = estimate_normals(torch.from_numpy(pts), torch.tensor(count), k=k).numpy()
    want = np.asarray(jax_estimate_normals(jnp.asarray(pts), jnp.int32(count), k=k))
    dots = np.sum(got[:count] * want[:count], axis=-1)
    assert dots.min() > 0.99999, dots.min()
    assert (got[count:] == 0).all()


def test_estimate_normals_match_the_host_twin():
    rng = np.random.RandomState(7)
    pts = make_surface_cloud(rng, 2000)
    host = normal_redirect_np(pts, estimate_normals_np(pts, 33), np.zeros(3, np.float32))
    dev = estimate_normals(torch.from_numpy(pts), 2000, k=33).numpy()
    dots = np.sum(host * dev, axis=-1)
    assert (dots > 0.999).mean() >= 0.98, (dots.min(), (dots > 0.999).mean())


def test_device_prep_pair_matches_jax():
    """Normals for the sides asked only, the source side from the raw
    points; the other sides keep what they carry."""
    tcfg, _, jcfg, _ = port_and_params(0)
    arr = pair_arrays(2)
    arr["src_raw_points"] = arr["src_points"] + 0.25  # differs from src_points
    for est in ((True, True), (False, True), (True, False)):
        got = device_prep_pair(torch_pair(arr), tcfg, est)
        want = jax_device_prep_pair(jax_pair(arr), jcfg, est, pyramid=False)
        for side, asked in zip(("src", "tgt"), est):
            g = getattr(got, f"{side}_normals").numpy()
            w = np.asarray(getattr(want, f"{side}_normals"))
            if asked:
                n = int(arr[f"{side}_count"])
                assert np.sum(g[:n] * w[:n], axis=-1).min() > 0.99999, (est, side)
                assert (g[n:] == 0).all()
            else:
                np.testing.assert_array_equal(g, arr[f"{side}_normals"])
