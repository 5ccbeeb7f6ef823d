"""Port model modules against the JAX package's modules of the same name,
same weights, same inputs (CPU, fp32): embeddings, local and global
attention layers and the geometric transformer. The backbone, whose JAX
run shares its op-by-op compiles with the whole-model tests, is in
test_torch_pipeline.py.

Tolerance: rtol 1e-4 / atol 1e-5 on fp32 outputs; indices exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.models import attention as ta
from roitr_torch.models import embeddings as te
from roitr_torch.models.transformer import GeometricTransformer
from roitr_tpu.models import attention as ja
from roitr_tpu.models import embeddings as je
from roitr_tpu.models import transformer as jt


TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy()


def dense(lin):
    return {"kernel": _np(lin.weight).T, "bias": _np(lin.bias)}


def layer_norm(norm):
    return {"scale": _np(norm.weight), "bias": _np(norm.bias)}


def ffn(mod):
    return {"expand": dense(mod.expand), "squeeze": dense(mod.squeeze), "norm": layer_norm(mod.norm)}


def local_params(mod: ta.LocalPPFTransformer):
    att = mod.transformer
    return {
        "embedding_proj": dense(mod.embedding.proj), "in_proj": dense(mod.in_proj),
        "out_proj": dense(mod.out_proj),
        "attention": {**{k: dense(v) for k, v in att.attention.items()},
                      "linear": dense(att.linear), "norm": layer_norm(att.norm)},
    }


def self_layer_params(mod: ta.RPESelfLayer):
    att = mod.attention
    g = att.attention
    return {
        "attention": {"proj_q": dense(g.proj_q), "proj_k": dense(g.proj_k),
                      "proj_v": dense(g.proj_v),
                      "proj_p_kernel": _np(g.proj_p.weight).T, "proj_p_bias": _np(g.proj_p.bias),
                      "proj_vp_kernel": _np(g.proj_vp.weight).T,
                      "proj_vp_bias": _np(g.proj_vp.bias)},
        "linear": dense(att.linear), "norm": layer_norm(att.norm),
        "pos_linear": dense(att.pos_linear), "pos_norm": layer_norm(att.pos_norm),
        "output": ffn(mod.output), "pos_proj": ffn(mod.pos_proj),
    }


def cross_layer_params(mod: ta.CrossAttentionLayer):
    att = mod.attention
    return {**{k: dense(v) for k, v in att.attention.items()}, "linear": dense(att.linear),
            "norm": layer_norm(att.norm), "output": ffn(mod.output)}


def _seeded(module, seed=0):
    from roitr_torch.models.roitr import init_weights

    init_weights(module, torch.Generator().manual_seed(seed))
    return module.eval()


def test_sinusoidal_embedding(rng):
    x = (rng.rand(7, 5) * 30).astype(np.float32)
    np.testing.assert_allclose(_np(te.sinusoidal_embedding(_t(x), 64)),
                               np.asarray(je.sinusoidal_embedding(jnp.asarray(x), 64)), **TOL)


@pytest.mark.parametrize("n,count", [(24, 20), (4, 2)])
def test_geometric_structure_embedding(rng, n, count):
    """Includes a node set smaller than angle_k + 1 (the k clamp and the
    self-replacement of padding neighbors)."""
    pts = np.zeros((n, 3), np.float32)
    pts[:count] = rng.rand(count, 3)
    mod = _seeded(te.GeometricStructureEmbedding(64))
    got = _np(mod(_t(pts), torch.tensor(count)))
    jmod = je.GeometricStructureEmbedding(64, backend="xla")
    want = jmod.apply({"params": {"proj_d": dense(mod.proj_d), "proj_a": dense(mod.proj_a)}},
                      jnp.asarray(pts), count)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_local_ppf_transformer(rng):
    n, m, k = 40, 12, 6
    feats = rng.randn(n, 8).astype(np.float32)
    node_idx = rng.choice(n, m, replace=False)
    group_idx = rng.randint(0, n, (m, k))
    ppf = rng.rand(m, k, 4).astype(np.float32)
    nmask = rng.rand(m, k) > 0.2
    mod = _seeded(ta.LocalPPFTransformer(8, 32, 16, 4))
    for centers in (node_idx, None):
        gi = group_idx if centers is not None else rng.randint(0, n, (n, k))
        pp = ppf if centers is not None else rng.rand(n, k, 4).astype(np.float32)
        nm = nmask if centers is not None else rng.rand(n, k) > 0.2
        got = mod(_t(feats), None if centers is None else _t(centers), _t(gi), _t(pp), _t(nm))
        want = ja.LocalPPFTransformer(8, 32, 16, 4).apply(
            {"params": local_params(mod)}, jnp.asarray(feats),
            None if centers is None else jnp.asarray(centers), jnp.asarray(gi), jnp.asarray(pp),
            jnp.asarray(nm))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rpe_self_layer(rng):
    n, d = 20, 64
    x = rng.randn(n, d).astype(np.float32)
    embed = (rng.randn(n, n, d) * 0.5).astype(np.float32)
    mask = np.arange(n) < 17
    mod = _seeded(ta.RPESelfLayer(d, 4))
    out, pos = mod(_t(x), _t(embed), _t(mask))
    jout, jpos = ja.RPESelfLayer(d, 4).apply({"params": self_layer_params(mod)}, jnp.asarray(x),
                                             jnp.asarray(embed), jnp.asarray(mask))
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(pos), np.asarray(jpos), **TOL)


def test_cross_attention_layer(rng):
    n, m, d = 14, 11, 64
    x, pq = rng.randn(2, n, d).astype(np.float32)
    mem, pk = rng.randn(2, m, d).astype(np.float32)
    mask = np.arange(m) < 9
    mod = _seeded(ta.CrossAttentionLayer(d, 4))
    got = mod(_t(x), _t(mem), _t(pq), _t(pk), _t(mask))
    want = ja.CrossAttentionLayer(d, 4).apply(
        {"params": cross_layer_params(mod)}, *map(jnp.asarray, (x, mem, pq, pk, mask)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_geometric_transformer(rng):
    blocks = ("self", "cross", "self", "cross")
    n, m, c, h = 24, 20, 32, 64
    rp = np.zeros((n, 3), np.float32)
    sp = np.zeros((m, 3), np.float32)
    rp[:21], sp[:18] = rng.rand(21, 3), rng.rand(18, 3)
    rf, sf = rng.randn(n, c).astype(np.float32), rng.randn(m, c).astype(np.float32)
    rmask, smask = np.arange(n) < 21, np.arange(m) < 18
    mod = _seeded(GeometricTransformer(c, c, h, 4, blocks, embedding_storage="fp32"))
    got = mod(_t(rp), _t(sp), _t(rf), _t(sf), torch.tensor(21), torch.tensor(18), _t(rmask),
              _t(smask))
    params = {"embedding": {"proj_d": dense(mod.embedding.proj_d),
                            "proj_a": dense(mod.embedding.proj_a)},
              "in_proj": dense(mod.in_proj), "out_proj": dense(mod.out_proj)}
    for i, (b, layer) in enumerate(zip(blocks, mod.transformer.layers)):
        params[f"layers_{i}"] = self_layer_params(layer) if b == "self" else cross_layer_params(layer)
    want = jt.GeometricTransformer(c, c, h, 4, blocks, embedding_storage="fp32").apply(
        {"params": params}, *map(jnp.asarray, (rp, sp, rf, sf)), 21, 18, jnp.asarray(rmask),
        jnp.asarray(smask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_coarse_matching(rng):
    from roitr_torch.models.matching import coarse_matching
    from roitr_tpu.models.matching import coarse_matching as jax_coarse_matching

    ref = rng.randn(20, 16).astype(np.float32)
    src = rng.randn(17, 16).astype(np.float32)
    ref /= np.linalg.norm(ref, axis=1, keepdims=True)
    src /= np.linalg.norm(src, axis=1, keepdims=True)
    rm, sm = np.arange(20) < 18, np.arange(17) < 15
    for dual in (True, False):
        got = coarse_matching(_t(ref), _t(src), _t(rm), _t(sm), 32, dual_normalization=dual)
        want = jax_coarse_matching(jnp.asarray(ref), jnp.asarray(src), jnp.asarray(rm),
                                   jnp.asarray(sm), 32, dual_normalization=dual)
        for name in ("ref_indices", "src_indices", "masks"):
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_allclose(_np(got.scores), np.asarray(want.scores), **TOL)


def _fine_rows(out):
    """Kept correspondences as sorted rows [ref xyz, src xyz, score]: the
    fast path's slot order differs from the exact path's, the set does not."""
    keep = np.asarray(out.masks)
    rows = np.concatenate([np.asarray(out.ref_points)[keep], np.asarray(out.src_points)[keep],
                           np.asarray(out.scores)[keep][:, None]], axis=1)
    return rows[np.lexsort(rows[:, :6].T[::-1])]


@pytest.mark.parametrize("mutual,use_dustbin,allow_fast,use_global", [
    (True, False, True, False),    # the fast path (the serving default)
    (True, False, False, True),    # the exact path, same selection
    (False, False, True, False),   # exact: not mutual
    (True, True, True, False),     # exact: the dustbin competes in the top-k
])
def test_fine_matching(rng, mutual, use_dustbin, allow_fast, use_global):
    """Tie-free logits; both packages give the same set of kept pairs."""
    from roitr_torch.models.matching import fine_matching
    from roitr_tpu.models.matching import fine_matching as jax_fine_matching

    p, kk = 5, 8
    side = kk + 1 if use_dustbin else kk
    ref_pts, src_pts = rng.rand(2, p, kk, 3).astype(np.float32)
    rmask, smask = rng.rand(2, p, kk) > 0.15
    logits = (rng.randn(p, side, side) * 2 - 2.5).astype(np.float32)
    pmask = np.array([True, True, False, True, True])
    gscores = rng.rand(p).astype(np.float32)
    kw = dict(k=3, mutual=mutual, confidence_threshold=0.05, use_global_score=use_global,
              use_dustbin=use_dustbin, allow_fast=allow_fast)
    got = fine_matching(*map(_t, (ref_pts, src_pts, rmask, smask, logits, pmask)),
                        global_scores=_t(gscores), **kw)
    want = jax_fine_matching(*map(jnp.asarray, (ref_pts, src_pts, rmask, smask, logits, pmask)),
                             global_scores=jnp.asarray(gscores), **kw)
    g, w = _fine_rows(got), _fine_rows(want)
    assert g.shape == w.shape and g.shape[0] > 0
    np.testing.assert_array_equal(g[:, :6], w[:, :6])
    np.testing.assert_allclose(g[:, 6], w[:, 6], **TOL)
