"""The plain versions of the port's three backward kernels against the JAX
package's backward oracles on the CPU, and the autograd Functions that
join each forward and backward kernel.

Each oracle is the JAX package's own: the interpret-mode VJP of the Pallas
kernel (custom VJP -> `_pallas_backward` in interpret mode), and the XLA
formulation it was certified against (autodiff of the checkpointed
Sinkhorn scan, `jax.vjp` of `xla_forward`, `_xla_bwd_scan`). Inputs are
made with numpy from a seed and handed to both packages.

Tolerances: fp32 gradients within rtol 1e-4 / atol 1e-5 (both packages sum
in fp32, in different orders); a bf16 embedding gradient within one bf16
step (1/128) of its largest value, since the fp32 sums before the cast may
round to either neighbour. `torch.autograd.gradcheck` runs each Function's
CPU path in float64 at a tiny size with its default tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch import kernels
from roitr_torch.kernels.geo_embedding_kernel import (
    geo_embedding,
    geo_embedding_bwd,
    geo_embedding_bwd_plain,
    geo_embedding_plain,
)
from roitr_torch.kernels.rpe_attention_kernel import (
    rpe_attention,
    rpe_attention_bwd,
    rpe_attention_bwd_plain,
)
from roitr_torch.kernels.sinkhorn_kernel import sinkhorn, sinkhorn_bwd, sinkhorn_bwd_plain
from roitr_torch.ops.sinkhorn import log_sinkhorn_ot, sinkhorn_inputs
from roitr_tpu.ops.pallas import geo_embedding_kernel as jgeo
from roitr_tpu.ops.pallas import rpe_attention_kernel as jrpe
from roitr_tpu.ops.pallas.sinkhorn_kernel import sinkhorn_iterate_pallas
from roitr_tpu.ops.sinkhorn import log_sinkhorn_ot as jax_log_sinkhorn_ot

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---- Sinkhorn: (4, 9, 9) x 20, a cotangent on valid entries only (the
# fine loss reads nothing else; at -1e6 entries the two backends' rounding
# of the +-1e6 exponents legitimately differs)

def _sinkhorn_case(seed=0, p=4, k=8):
    rng = np.random.RandomState(seed)
    scores = torch.from_numpy(rng.randn(p, k, k).astype(np.float32))
    rm = torch.from_numpy(rng.rand(p, k) > 0.25)
    cm = torch.from_numpy(rng.rand(p, k) > 0.25)
    rm[:, 0] = cm[:, 0] = True
    padded, mu, nu, _ = sinkhorn_inputs(scores, rm, cm, torch.tensor(0.7))
    valid = (padded > -1e5).numpy()
    g = rng.randn(p, k + 1, k + 1).astype(np.float32) * valid
    return scores, rm, cm, padded, mu, nu, torch.from_numpy(g)


def test_sinkhorn_bwd_plain_matches_pallas_vjp():
    _, _, _, padded, mu, nu, g = _sinkhorn_case()
    _, vjp = jax.vjp(lambda s, a, b: sinkhorn_iterate_pallas(s, a, b, 20, True),
                     jnp.asarray(padded.numpy()), jnp.asarray(mu.numpy()), jnp.asarray(nu.numpy()))
    want = vjp(jnp.asarray(g.numpy()))
    got = sinkhorn_bwd_plain(padded, mu, nu, g, 20)
    for name, a, b in zip(("ds", "dmu", "dnu"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **TOL)


def test_sinkhorn_grads_match_checkpointed_scan():
    """d(scores) and d(alpha) of the whole OT through the Function against
    JAX autodiff of the checkpointed XLA scan."""
    scores, rm, cm, padded, _, _, g = _sinkhorn_case(seed=1)
    s = scores.clone().requires_grad_(True)
    alpha = torch.tensor(0.7, requires_grad=True)
    (log_sinkhorn_ot(s, rm, cm, alpha, num_iter=20) * g).sum().backward()

    def loss(sc, a):
        out = jax_log_sinkhorn_ot(sc, jnp.asarray(rm.numpy()), jnp.asarray(cm.numpy()), a,
                                  num_iter=20, backend="xla", differentiable=True)
        return jnp.sum(out * jnp.asarray(g.numpy()))

    ds, dalpha = jax.grad(loss, argnums=(0, 1))(jnp.asarray(scores.numpy()), jnp.float32(0.7))
    np.testing.assert_allclose(_np(s.grad), np.asarray(ds), **TOL)
    np.testing.assert_allclose(float(alpha.grad), float(dalpha), **TOL)


def test_sinkhorn_function_gradcheck():
    rng = np.random.RandomState(2)
    args = [torch.from_numpy(rng.randn(*shape)).requires_grad_(True)
            for shape in ((2, 3, 4), (2, 3), (2, 4))]
    assert torch.autograd.gradcheck(lambda a, b, c: sinkhorn(a, b, c, 5), args)


# ---- RPE attention: N 21 (not a multiple of the JAX backward's 8-row
# tile, so its pad rows are exercised) and 24, D 32, H 4, three masked keys

def _rpe_case(n, seed, dtype):
    rng = np.random.RandomState(seed)
    d, h = 32, 4
    arr = dict(q2=rng.randn(n, d), k2=rng.randn(n, d), v2=rng.randn(n, d),
               qwp=rng.randn(n, h, d) * 0.3, embed=rng.randn(n, n, d) * 0.5,
               ghid=rng.randn(n, d), gae=rng.randn(n, h, d))
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    mask = np.ones(n, np.float32)
    mask[-3:] = 0.0
    arr["mask"] = mask
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    t["embed"] = t["embed"].to(dtype)
    return arr, t


@pytest.mark.parametrize("n", [21, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_rpe_attention_bwd_plain_matches_jax(n, dtype):
    arr, t = _rpe_case(n, seed=n, dtype=dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    prim = [jnp.asarray(arr[k]) for k in ("q2", "k2", "v2", "qwp")]
    emb = jnp.asarray(arr["embed"]).astype(jdt)
    mask = jnp.asarray(arr["mask"])
    cot = (jnp.asarray(arr["ghid"]), jnp.asarray(arr["gae"]))
    got = rpe_attention_bwd_plain(t["q2"], t["k2"], t["v2"], t["qwp"], t["embed"], t["mask"],
                                  t["ghid"], t["gae"])
    assert got[4].dtype == dtype
    oracles = {
        "pallas_interpret": lambda a, b, c, w, e: jrpe.fused_rpe_self_attention(
            a, b, c, w, e, mask, True),
        "xla_forward": lambda a, b, c, w, e: jrpe.xla_forward(a, b, c, w, e, mask),
    }
    for oracle, fn in oracles.items():
        _, vjp = jax.vjp(fn, *prim, emb)
        want = vjp(cot)
        for name, a, b in zip(("dq", "dk", "dv", "dqwp", "demb"), got, want):
            a, b = _np(a), np.asarray(b.astype(jnp.float32))
            if name == "demb" and dtype == torch.bfloat16:
                assert np.abs(a - b).max() <= np.abs(b).max() / 128, (oracle, name)
            else:
                np.testing.assert_allclose(a, b, err_msg=f"{oracle} {name}", **TOL)


def test_rpe_attention_function_gradcheck():
    rng = np.random.RandomState(3)
    n, d, h = 5, 8, 2
    shapes = ((n, d), (n, d), (n, d), (n, h, d), (n, n, d))
    args = [torch.from_numpy(rng.randn(*s)).requires_grad_(True) for s in shapes]
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: rpe_attention(*a, mask), args)


# ---- geometric embedding: R 256, H 32, k 3, every 16th row a tie row (the
# padded-neighbour rows of models/embeddings.py: all k angles equal)

def _geo_case(seed=0, r=256, k=3, hidden=32):
    rng = np.random.RandomState(seed)
    d = (rng.rand(r) * 30).astype(np.float32)
    a = (rng.rand(r, k) * 12).astype(np.float32)
    a[::16] = a[::16, :1]  # tie rows
    w = [(rng.randn(hidden, hidden) * 0.1).astype(np.float32) for _ in range(2)]
    b = [(rng.randn(hidden) * 0.1).astype(np.float32) for _ in range(2)]
    g = rng.randn(r, hidden).astype(np.float32)
    return d, a, w[0], b[0], w[1], b[1], g


def test_geo_embedding_argmax_map_matches_pallas():
    d, a, wd, bd, wa, ba, _ = _geo_case()
    t = [torch.from_numpy(x) for x in (d, a, wd, bd, wa, ba)]
    _, amax = geo_embedding_plain(*t, with_argmax=True)
    _, jmap = jgeo._pallas_forward(*[jnp.asarray(x) for x in (d, a, wd, bd, wa, ba)],
                                   interpret=True, with_argmax=True)
    mism = float((amax.numpy() != np.asarray(jmap)).mean())
    assert mism <= 1e-3, f"{mism:.4%} of the map differs (near-ties within rounding)"
    assert (amax.numpy()[::16] == 0).all()  # ties keep the first k


def test_geo_embedding_bwd_plain_matches_jax():
    """Given the JAX kernel's own map, the plain backward equals the
    interpret-mode VJP; given the port's map, it equals `_xla_bwd_scan`."""
    d, a, wd, bd, wa, ba, g = _geo_case(seed=1)
    jargs = [jnp.asarray(x) for x in (d, a, wd, bd, wa, ba)]
    _, jmap = jgeo._pallas_forward(*jargs, interpret=True, with_argmax=True)
    _, vjp = jax.vjp(lambda w1, b1, w2, b2: jgeo.fused_geo_embedding(
        jargs[0], jargs[1], w1, b1, w2, b2, True, jnp.float32), *jargs[2:])
    j_dwd, j_dbd, j_dwa, j_dba = vjp(jnp.asarray(g))
    got = geo_embedding_bwd_plain(torch.from_numpy(d), torch.from_numpy(a),
                                  torch.from_numpy(np.array(jmap)), torch.from_numpy(g), 32)
    for name, x, y in zip(("dwd", "dbd", "dwa"), got, (j_dwd, j_dbd, j_dwa)):
        np.testing.assert_allclose(_np(x), np.asarray(y), err_msg=f"interpret {name}", **TOL)
    np.testing.assert_allclose(np.asarray(j_dba), np.asarray(j_dbd), **TOL)

    _, amax = geo_embedding_plain(*[torch.from_numpy(x) for x in (d, a, wd, bd, wa, ba)],
                                  with_argmax=True)
    got = geo_embedding_bwd_plain(torch.from_numpy(d), torch.from_numpy(a), amax,
                                  torch.from_numpy(g), 32)
    x_dwd, x_dbd, x_dwa, _ = jgeo._xla_bwd_scan(*jargs[:2], jargs[2], jargs[4], jnp.asarray(g))
    for name, x, y in zip(("dwd", "dbd", "dwa"), got, (x_dwd, x_dbd, x_dwa)):
        np.testing.assert_allclose(_np(x), np.asarray(y), err_msg=f"scan {name}", **TOL)


def test_geo_embedding_function_gradcheck():
    rng = np.random.RandomState(4)
    r, k, hidden = 6, 2, 4
    d = torch.from_numpy(rng.rand(r) * 5)
    a = torch.from_numpy(rng.rand(r, k) * 5)
    w = [torch.from_numpy(rng.randn(*s) * 0.5).requires_grad_(True)
         for s in ((hidden, hidden), (hidden,), (hidden, hidden), (hidden,))]
    assert torch.autograd.gradcheck(
        lambda *p: geo_embedding(d, a, *p, out_dtype=torch.float64), w)


def test_cpu_tensors_take_the_plain_versions():
    """The Functions' CPU path runs the plain versions: no launch counted."""
    before = dict(kernels.launch_counts)
    _, _, _, padded, mu, nu, g = _sinkhorn_case()
    for got, want in zip(sinkhorn_bwd(padded, mu, nu, g, 3),
                         sinkhorn_bwd_plain(padded, mu, nu, g, 3)):
        assert torch.equal(got, want)
    _, t = _rpe_case(9, 0, torch.float32)
    args = [t[k] for k in ("q2", "k2", "v2", "qwp", "embed", "mask", "ghid", "gae")]
    for got, want in zip(rpe_attention_bwd(*args), rpe_attention_bwd_plain(*args)):
        assert torch.equal(got, want)
    d, a, _, _, _, _, g = _geo_case(r=32)
    amax = torch.zeros((32, 32), dtype=torch.int8)
    for got, want in zip(geo_embedding_bwd(torch.from_numpy(d), torch.from_numpy(a), amax,
                                           torch.from_numpy(g), 32),
                         geo_embedding_bwd_plain(torch.from_numpy(d), torch.from_numpy(a), amax,
                                                 torch.from_numpy(g), 32)):
        assert torch.equal(got, want)
    assert kernels.launch_counts == before
