"""The one-pass RPE attention backward and the kernels' shape gates, on the
CPU.

`rpe_attention_bwd_onepass_plain` is the CPU emulation of the card's
backward (csrc/rpe_attention.cu): every probability recomputed as
exp(score - lse) from the forward's log-sum-exps, and the two softmax VJPs'
row sums taken from the forward's outputs (ghid . hidden, gae . ae) instead
of a sum over the keys. It is held against `jax.vjp` of the JAX package's
`xla_forward` and against the two-pass `rpe_attention_bwd_plain`, with
inputs made by numpy from a seed. Tolerances: fp32 gradients within
rtol 1e-4 / atol 1e-5 (fp32 sums in different orders); a bf16 embedding
gradient within one bf16 step (1/128) of its largest value.

The gates (`supported_shape`, `supported_shape_bwd`, `supported_heads`,
`supported_width`, `supported_k`) are checked at and beyond each boundary,
and so is the route each caller takes by them: `log_sinkhorn_ot` by
`differentiable` as in the JAX package, the RPE attention layer by head
count and width, the geometric embedding by its angle neighbours.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.kernels.geo_embedding_kernel import supported_k
from roitr_torch.kernels.rpe_attention_kernel import (
    _scores,
    fused_rpe_self_attention,
    rpe_attention_bwd_onepass_plain,
    rpe_attention_bwd_plain,
    rpe_attention_plain,
    supported_heads,
    supported_width,
)
from roitr_torch.kernels.sinkhorn_kernel import supported_shape, supported_shape_bwd
from roitr_torch.ops import sinkhorn as ops_sinkhorn
from roitr_tpu.ops.pallas.rpe_attention_kernel import xla_forward

TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dq", "dk", "dv", "dqwp", "demb")

# (n, d, h, valid keys): a masked tail; one head; eight; one valid key, so
# that row 0's positional softmax is empty and every other row keeps one key
CASES = {
    "tail": (21, 32, 4, 18),
    "h1": (24, 32, 1, 24),
    "h8": (16, 64, 8, 13),
    "one_key": (9, 32, 4, 1),
}


def _case(n, d, h, valid, seed, dtype):
    rng = np.random.RandomState(seed)
    arr = dict(q2=rng.randn(n, d), k2=rng.randn(n, d), v2=rng.randn(n, d),
               qwp=rng.randn(n, h, d) * 0.3, embed=rng.randn(n, n, d) * 0.5,
               ghid=rng.randn(n, d), gae=rng.randn(n, h, d))
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    arr["mask"] = (np.arange(n) < valid).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    t["embed"] = t["embed"].to(dtype)
    if dtype == torch.bfloat16:  # both packages see the same rounded embedding
        arr["embed"] = t["embed"].float().numpy()
    return arr, t


def _assert_grads(got, want, dtype, label):
    for name, a, b in zip(NAMES, got, want):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if name == "demb" and dtype == torch.bfloat16:
            assert np.abs(a - b).max() <= np.abs(b).max() / 128, (label, name)
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{label} {name}", **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_onepass_backward_matches_jax_and_the_two_pass_plain(case, dtype):
    n, d, h, valid = CASES[case]
    arr, t = _case(n, d, h, valid, seed=n + h, dtype=dtype)
    args = [t[k] for k in ("q2", "k2", "v2", "qwp", "embed", "mask")]
    hidden, ae, lse_attn, lse_pos = rpe_attention_plain(*args, with_lse=True)
    got = rpe_attention_bwd_onepass_plain(*args, t["ghid"], t["gae"], hidden, ae, lse_attn,
                                          lse_pos)
    assert got[4].dtype == dtype
    for g in got:
        assert torch.isfinite(g.float()).all()

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mask = jnp.asarray(arr["mask"])
    _, vjp = jax.vjp(lambda a, b, c, w, e: xla_forward(a, b, c, w, e, mask),
                     *[jnp.asarray(arr[k]) for k in ("q2", "k2", "v2", "qwp")],
                     jnp.asarray(arr["embed"]).astype(jdt))
    want = [x.astype(jnp.float32) for x in vjp((jnp.asarray(arr["ghid"]),
                                                 jnp.asarray(arr["gae"])))]
    _assert_grads(got, want, dtype, "jax.vjp(xla_forward)")
    _assert_grads(got, rpe_attention_bwd_plain(*args, t["ghid"], t["gae"]), dtype,
                  "rpe_attention_bwd_plain")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lse_matches_torch_logsumexp(case):
    """The plain forward's log-sum-exps against torch.logsumexp over the
    masked scores; +inf for a row with no kept key (torch gives -inf),
    and the same on the wrapper's CPU path."""
    n, d, h, valid = CASES[case]
    _, t = _case(n, d, h, valid, seed=7 * n, dtype=torch.float32)
    args = [t[k] for k in ("q2", "k2", "v2", "qwp", "embed", "mask")]
    hidden, ae, lse_attn, lse_pos = rpe_attention_plain(*args, with_lse=True)
    assert lse_attn.shape == lse_pos.shape == (n, h)
    scores, keep, keep_pos = _scores(t["q2"], t["k2"], t["qwp"], t["embed"], t["mask"])
    for got, kept in ((lse_attn, keep), (lse_pos, keep_pos)):
        want = torch.logsumexp(torch.where(kept, scores, torch.tensor(-math.inf)), dim=-1).t()
        any_kept = kept.expand_as(scores).any(dim=-1).t()
        np.testing.assert_allclose(got[any_kept].numpy(), want[any_kept].numpy(), **TOL)
        assert torch.isposinf(got[~any_kept]).all()
    if case == "one_key":
        assert torch.isposinf(lse_pos[0]).all() and torch.isfinite(lse_attn).all()
    for a, b in zip(fused_rpe_self_attention(*args, with_lse=True),
                    (hidden, ae, lse_attn, lse_pos)):
        assert torch.equal(a, b)


def test_sinkhorn_gates_at_their_boundaries():
    # m1 = n1 = point_per_patch + 1 (the dustbin)
    assert supported_shape(65, 65) and supported_shape_bwd(65, 65, 100)
    assert supported_shape_bwd(126, 126, 100)          # point_per_patch 125
    assert not supported_shape_bwd(127, 127, 100)      # point_per_patch 126
    assert supported_shape(239, 239)                   # point_per_patch 238
    assert not supported_shape(240, 240)               # point_per_patch 239
    assert supported_shape_bwd(65, 65, 379)
    assert not supported_shape_bwd(65, 65, 380)
    assert not supported_shape_bwd(65, 65, 0)
    assert supported_shape(1, 1) and supported_shape_bwd(1, 1, 1)


def test_rpe_and_geo_gates_at_their_boundaries():
    assert supported_heads(1) and supported_heads(4) and supported_heads(16)
    assert not supported_heads(17) and not supported_heads(0)
    assert supported_width(8) and supported_width(256) and supported_width(512)
    assert not supported_width(12) and not supported_width(4)
    assert supported_k(1) and supported_k(3) and supported_k(127)
    assert not supported_k(128) and not supported_k(0)


@pytest.mark.parametrize("differentiable", [False, True])
def test_log_sinkhorn_route_follows_differentiable(monkeypatch, differentiable):
    """As roitr_tpu/ops/sinkhorn.py:80-93: a differentiable call is gated on
    the backward's shape, any other on the forward's. At 126 points a side
    (127 with the dustbin) and 100 iterations the forward kernel takes the
    patch and the backward does not; at 64 both take it."""
    assert ops_sinkhorn.kernel_takes(127, 127, 100, differentiable) == (not differentiable)
    assert ops_sinkhorn.kernel_takes(65, 65, 100, differentiable)
    assert ops_sinkhorn.kernel_takes(65, 65, 380, differentiable) == (not differentiable)
    routes = []
    real = ops_sinkhorn.sinkhorn

    def spy(padded, log_mu, log_nu, num_iter, kernel=True):
        routes.append(kernel)
        return real(padded, log_mu, log_nu, num_iter, kernel)

    monkeypatch.setattr(ops_sinkhorn, "sinkhorn", spy)
    rng = np.random.RandomState(5)
    for m in (126, 64):
        scores = torch.from_numpy(rng.randn(1, m, m).astype(np.float32)).requires_grad_(True)
        masks = torch.ones(1, m, dtype=torch.bool)
        out = ops_sinkhorn.log_sinkhorn_ot(scores, masks, masks, torch.tensor(1.0), num_iter=100,
                                           differentiable=differentiable)
        out.sum().backward()
        assert torch.isfinite(scores.grad).all()
    assert routes == [not differentiable, True]


def test_sinkhorn_plain_route_gives_the_kernel_route_result():
    """On the CPU both routes run the plain loop: same values and gradients."""
    base = np.random.RandomState(6).randn(2, 6, 6).astype(np.float32)
    mu, nu = torch.full((2, 6), -1.8), torch.full((2, 6), -1.8)
    got = []
    for kernel in (True, False):
        s = torch.from_numpy(base).requires_grad_(True)
        out = ops_sinkhorn.sinkhorn(s, mu, nu, 5, kernel=kernel)
        (out * torch.arange(72.0).reshape(2, 6, 6)).sum().backward()
        got.append((out.detach(), s.grad))
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_model_layers_route_by_the_gates(monkeypatch):
    """The RPE attention layer takes the kernel's entry at 4 heads and the
    plain version at 17 (or at a width the backward does not take); the
    geometric embedding takes the plain version at 128 angle neighbours.
    Gradients reach every weight on the plain routes."""
    from roitr_torch.models import attention, embeddings

    calls = []
    real_rpe = attention.rpe_attention

    def rpe_spy(*args):
        calls.append("kernel")
        return real_rpe(*args)

    monkeypatch.setattr(attention, "rpe_attention", rpe_spy)
    rng = np.random.RandomState(8)
    for d, h, want in ((32, 4, ["kernel"]), (34, 17, []), (36, 4, [])):
        calls.clear()
        torch.manual_seed(0)
        layer = attention.GlobalRPESelfAttention(d, h)
        x = torch.from_numpy(rng.randn(10, d).astype(np.float32))
        e = torch.from_numpy(rng.randn(10, 10, d).astype(np.float32))
        hidden, pos = layer(x, e)
        (hidden.sum() + pos.sum()).backward()
        assert calls == want, (d, h)
        assert all(p.grad is not None for n_, p in layer.named_parameters() if n_ != "proj_p.bias")

    def geo_refused(*args, **kwargs):
        raise AssertionError("the geometric embedding kernel's entry at k > 127")

    monkeypatch.setattr(embeddings, "geo_embedding", geo_refused)
    emb = embeddings.GeometricStructureEmbedding(8, angle_k=128)
    pts = torch.from_numpy(rng.rand(130, 3).astype(np.float32))
    out = emb(pts)
    assert out.shape == (130, 130, 8) and torch.isfinite(out).all()
    out.sum().backward()
    assert emb.proj_a.weight.grad is not None and emb.proj_d.weight.grad is not None
