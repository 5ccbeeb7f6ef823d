"""The Sinkhorn line kernels' arithmetic, emulated by plain PyTorch on the
CPU, against the plain versions and the JAX package's oracles; the
trajectory that the differentiable forward hands to the backward; the shape
dispatch between the line and the general kernels.

Inputs are made with numpy from a seed, at `_sinkhorn_case` size (4
patches, 8 points a side, 20 iterations) or the plain test's (5, 11, 9).
Tolerances: rtol 1e-4 / atol 1e-5 against JAX (both sum in fp32, in other
orders); the split ds accumulation within 1e-6 of max|ref| of the plain
loop's (the same fp32 terms summed in another order, at most 40 of them);
a backward fed the forward's own trajectory bit-equal to the recomputing
one (the same fp32 operations on the same values).
"""

import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch import kernels
from roitr_torch.kernels import sinkhorn_kernel as sk
from roitr_torch.ops.sinkhorn import sinkhorn_inputs
from roitr_tpu.ops.pallas.sinkhorn_kernel import sinkhorn_iterate_pallas
from roitr_tpu.ops.sinkhorn import log_sinkhorn_ot as jax_log_sinkhorn_ot

TOL = dict(rtol=1e-4, atol=1e-5)


def _case(seed=0, p=4, k=8, masked_slot=False):
    rng = np.random.RandomState(seed)
    scores = torch.from_numpy(rng.randn(p, k, k).astype(np.float32))
    rm = torch.from_numpy(rng.rand(p, k) > 0.25)
    cm = torch.from_numpy(rng.rand(p, k) > 0.25)
    rm[:, 0] = cm[:, 0] = True
    if masked_slot:
        rm[-1] = False
    padded, mu, nu, _ = sinkhorn_inputs(scores, rm, cm, torch.tensor(0.7))
    valid = (padded > -1e5).numpy()
    g = rng.randn(p, k + 1, k + 1).astype(np.float32) * valid
    return padded, mu, nu, torch.from_numpy(g)


@pytest.fixture
def counts_unchanged():
    before = dict(kernels.launch_counts)
    yield
    assert kernels.launch_counts == before


def test_forward_trajectory_is_the_loops(counts_unchanged):
    padded, mu, nu, _ = _case(masked_slot=True)
    out, traj_u, traj_v = sk.sinkhorn_iterate(padded, mu, nu, 20, with_traj=True)
    assert traj_u.shape == (4, 20, 9) and traj_v.shape == (4, 20, 9)
    assert torch.equal(out, sk.sinkhorn_plain(padded, mu, nu, 20))
    for t, (u, v) in enumerate(sk._trajectory(padded, mu, nu, 20)):
        assert torch.equal(traj_u[:, t], u) and torch.equal(traj_v[:, t], v)


@pytest.mark.parametrize("oracle", ["recompute", "pallas_vjp"])
def test_sinkhorn_bwd_from_trajectory(counts_unchanged, oracle):
    """Fed the forward's trajectory, the plain backward equals the one that
    recomputes it bit for bit, and the JAX kernel's interpret-mode VJP
    within TOL."""
    padded, mu, nu, g = _case(masked_slot=True)
    _, traj_u, traj_v = sk.sinkhorn_iterate(padded, mu, nu, 20, with_traj=True)
    got = sk.sinkhorn_bwd(padded, mu, nu, g, 20, traj=(traj_u, traj_v))
    if oracle == "recompute":
        for a, b in zip(got, sk.sinkhorn_bwd_plain(padded, mu, nu, g, 20)):
            assert torch.equal(a, b)
        return
    _, vjp = jax.vjp(lambda s, a, b: sinkhorn_iterate_pallas(s, a, b, 20, True),
                     jnp.asarray(padded.numpy()), jnp.asarray(mu.numpy()), jnp.asarray(nu.numpy()))
    want = vjp(jnp.asarray(g.numpy()))
    for name, a, b in zip(("ds", "dmu", "dnu"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("k,iters,masked_slot", [(8, 20, False), (16, 12, True)])
def test_sinkhorn_bwd_split_accumulation(k, iters, masked_slot):
    """ds as the line kernel forms it, (g - sum_t dv_t b_t) - sum_t du_t a_t,
    against the plain loop's running ds; dmu and dnu do not change."""
    padded, mu, nu, g = _case(seed=k, k=k, masked_slot=masked_slot)
    want = sk.sinkhorn_bwd_plain(padded, mu, nu, g, iters)
    got = sk.sinkhorn_bwd_split_plain(padded, mu, nu, g, iters)
    top = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-6 * top
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("iters", [10, 20])
def test_sinkhorn_base2_plain_matches_jax_scan(rng, iters):
    """The line kernel's base-2 loop (scores times log2 e, exp2 / log2,
    converted back at the output) against the JAX package's XLA scan, with
    a fully masked patch slot."""
    b, m, n = 5, 11, 9
    scores = rng.randn(b, m, n).astype(np.float32)
    rm, cm = rng.rand(b, m) > 0.2, rng.rand(b, n) > 0.2
    rm[:, 0] = cm[:, 0] = True
    rm[4] = False
    want = np.asarray(jax_log_sinkhorn_ot(jnp.asarray(scores), jnp.asarray(rm), jnp.asarray(cm),
                                          jnp.float32(1.3), num_iter=iters, backend="xla"))
    padded, mu, nu, norm = sinkhorn_inputs(torch.from_numpy(scores), torch.from_numpy(rm),
                                           torch.from_numpy(cm), torch.tensor(1.3))
    got = (sk.sinkhorn_base2_plain(padded, mu, nu, iters) - norm[:, None, None]).numpy()
    assert np.isfinite(got).all()
    valid = want > -1e5
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "no_input_grad", "kernel_false"])
def test_sinkhorn_saves_a_trajectory_only_for_a_gradient(monkeypatch, mode):
    """The differentiable entry asks the forward for the trajectory only when
    an input needs a gradient in grad mode (not while serving or validating,
    nor on the plain route), and its gradients equal the plain route's."""
    calls = []
    real = sk.sinkhorn_iterate

    def spy(padded, log_mu, log_nu, num_iter, with_traj=False):
        calls.append(with_traj)
        return real(padded, log_mu, log_nu, num_iter, with_traj)

    monkeypatch.setattr(sk, "sinkhorn_iterate", spy)
    padded, mu, nu, g = _case(seed=3)
    s = padded.clone().requires_grad_(mode != "no_input_grad")
    if mode == "no_grad":
        with torch.no_grad():
            out = sk.sinkhorn(s, mu, nu, 20)
    else:
        out = sk.sinkhorn(s, mu, nu, 20, kernel=mode != "kernel_false")
    assert calls == {"grad": [True], "no_grad": [False], "no_input_grad": [False],
                     "kernel_false": []}[mode]
    if mode == "grad":
        (out * g).sum().backward()
        ref = padded.clone().requires_grad_(True)
        (sk.sinkhorn(ref, mu, nu, 20, kernel=False) * g).sum().backward()
        assert torch.equal(s.grad, ref.grad)


def test_line_kernel_dispatch_mirrors_the_source():
    """The line kernels take lines of at most 65 (point_per_patch 64 and the
    dustbin), as csrc/sinkhorn.cu's kLines says; every such patch passes the
    forward's gate, and the backward's keeps its iteration limit."""
    src = (Path(sk.__file__).parents[1] / "csrc" / "sinkhorn.cu").read_text()
    assert int(re.search(r"constexpr int kLines = (\d+);", src).group(1)) == sk.LINE_KERNEL_LINES
    assert sk.line_kernel_takes(65, 65) and sk.line_kernel_takes(1, 1)
    assert sk.line_kernel_takes(12, 10) and sk.line_kernel_takes(65, 2)
    assert not sk.line_kernel_takes(66, 65) and not sk.line_kernel_takes(65, 66)
    assert all(sk.supported_shape(m, n) for m in range(1, 66) for n in range(1, 66))
    assert sk.supported_shape_bwd(65, 65, 379) and not sk.supported_shape_bwd(65, 65, 380)
