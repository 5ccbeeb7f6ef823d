"""The plain PyTorch version of each kernel against the JAX package's plain
reference of the same TPU kernel, on the CPU:

  fps_plain            <- roitr_tpu/ops/fps.py furthest_point_sampling
  geo_embedding_plain  <- geo_embedding_kernel._xla_forward
  rpe_attention_plain  <- rpe_attention_kernel.xla_forward
  sinkhorn_plain       <- the XLA scan of roitr_tpu/ops/sinkhorn.py

fp32 outputs within rtol 1e-4 / atol 1e-5, indices exactly. A wrapper given
CPU tensors must take its plain version and leave the launch counter alone.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch import kernels
from roitr_torch.kernels.fps_kernel import fps_pairs, fps_plain
from roitr_torch.kernels.geo_embedding_kernel import fused_geo_embedding, geo_embedding_plain
from roitr_torch.kernels.rpe_attention_kernel import fused_rpe_self_attention, rpe_attention_plain
from roitr_torch.kernels.sinkhorn_kernel import sinkhorn_iterate, sinkhorn_plain
from roitr_torch.ops.sinkhorn import log_sinkhorn_ot, sinkhorn_inputs
from roitr_tpu.ops.fps import furthest_point_sampling
from roitr_tpu.ops.pallas.geo_embedding_kernel import _xla_forward
from roitr_tpu.ops.pallas.rpe_attention_kernel import xla_forward
from roitr_tpu.ops.sinkhorn import log_sinkhorn_ot as jax_log_sinkhorn_ot

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def counts_unchanged():
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def _geo_inputs(rng, r=300, k=3, hidden=64):
    d = (rng.rand(r) * 20).astype(np.float32)
    a = (rng.rand(r, k) * 12).astype(np.float32)
    wd, wa = (rng.randn(2, hidden, hidden) / 8).astype(np.float32)
    bd, ba = (rng.randn(2, hidden) / 8).astype(np.float32)
    return d, a, wd, bd, wa, ba


def _rpe_inputs(rng, n=24, d=32, h=4, masked=(3, 17)):
    q2, k2, v2 = rng.randn(3, n, d).astype(np.float32)
    qwp = (rng.randn(n, h, d) * 0.3).astype(np.float32)
    embed = rng.randn(n, n, d).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[list(masked)] = 0.0
    return q2, k2, v2, qwp, embed, mask


def test_fps_plain_matches_jax(rng, counts_unchanged):
    pts = rng.rand(2, 384, 3).astype(np.float32)
    counts = np.array([384, 301], np.int32)
    got = fps_pairs(_t(pts), _t(counts), 96)
    assert got.dtype == torch.int32
    for b in range(2):
        want = np.asarray(furthest_point_sampling(pts[b], int(counts[b]), 96))
        np.testing.assert_array_equal(got[b].numpy(), want)
    np.testing.assert_array_equal(fps_plain(_t(pts), _t(counts), 96).numpy(), got.numpy())


@pytest.mark.parametrize("hidden,k", [(64, 3), (256, 2), (32, 1)])
def test_geo_embedding_plain_matches_jax(rng, counts_unchanged, hidden, k):
    d, a, wd, bd, wa, ba = _geo_inputs(rng, k=k, hidden=hidden)
    want = np.asarray(_xla_forward(jnp.asarray(d), jnp.asarray(a), wd, bd, wa, ba))
    got = fused_geo_embedding(*map(_t, (d, a, wd, bd, wa, ba)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(geo_embedding_plain(*map(_t, (d, a, wd, bd, wa, ba))).numpy(),
                                  got.numpy())
    bf16 = fused_geo_embedding(*map(_t, (d, a, wd, bd, wa, ba)), out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("bf16_embed", [False, True])
def test_rpe_attention_plain_matches_jax(rng, counts_unchanged, bf16_embed):
    q2, k2, v2, qwp, embed, mask = _rpe_inputs(rng)
    jembed = jnp.asarray(embed, jnp.bfloat16 if bf16_embed else jnp.float32)
    want_h, want_ae = xla_forward(*map(jnp.asarray, (q2, k2, v2, qwp)), jembed, jnp.asarray(mask))
    tembed = _t(embed).to(torch.bfloat16 if bf16_embed else torch.float32)
    got_h, got_ae = fused_rpe_self_attention(_t(q2), _t(k2), _t(v2), _t(qwp), tembed, _t(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_ae.numpy(), np.asarray(want_ae), **TOL)


def test_rpe_attention_fully_masked_gives_zeros(counts_unchanged):
    rng = np.random.RandomState(0)
    q2, k2, v2, qwp, embed, mask = _rpe_inputs(rng, n=8, masked=range(8))
    hid, ae = rpe_attention_plain(_t(q2), _t(k2), _t(v2), _t(qwp), _t(embed), _t(mask))
    assert not hid.any() and not ae.any()


@pytest.mark.parametrize("iters", [10, 20])
def test_sinkhorn_plain_matches_jax_scan(rng, counts_unchanged, iters):
    b, m, n = 5, 11, 9
    scores = rng.randn(b, m, n).astype(np.float32)
    rm, cm = rng.rand(b, m) > 0.2, rng.rand(b, n) > 0.2
    rm[:, 0] = cm[:, 0] = True
    rm[4] = False  # a fully-masked patch slot stays finite
    want = np.asarray(jax_log_sinkhorn_ot(jnp.asarray(scores), jnp.asarray(rm), jnp.asarray(cm),
                                          jnp.float32(1.3), num_iter=iters, backend="xla"))
    got = log_sinkhorn_ot(_t(scores), _t(rm), _t(cm), torch.tensor(1.3), num_iter=iters).numpy()
    assert np.isfinite(got).all()
    valid = want > -1e5
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
    padded, mu, nu, _ = sinkhorn_inputs(_t(scores), _t(rm), _t(cm), torch.tensor(1.3))
    np.testing.assert_array_equal(sinkhorn_iterate(padded, mu, nu, iters).numpy(),
                                  sinkhorn_plain(padded, mu, nu, iters).numpy())
