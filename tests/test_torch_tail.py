"""The tail of the port against the JAX package on the CPU: `knn_method`
"approx", the Sinkhorn convergence exit (`sinkhorn_tol`) and backend
"xla", every repo config building the model with no override, and the
modules off the main path (models/ppf_transformer.py, ops/legacy.py,
data/patches.py, utils/factory.py, utils/profiling.py).

Tolerances: continuous outputs rtol 1e-4 / atol 1e-5 (the Sinkhorn exit
and the PPF transformer), legacy ops atol 1e-5, factory layers atol 1e-6;
kNN indices and the patch helpers exactly.
"""

import glob
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.ops import neighbors as tn
from roitr_torch.ops.sinkhorn import log_sinkhorn_ot, sinkhorn_early_exit, sinkhorn_inputs
from roitr_tpu.ops import neighbors as jn
from roitr_tpu.ops.sinkhorn import log_sinkhorn_ot as jax_log_sinkhorn_ot

from torch_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "test", "*.yaml"))
                 + glob.glob(os.path.join(ROOT, "configs", "train", "*.yaml")))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- knn_method "approx": JAX's approx_min_k, which XLA computes exactly
# off the TPU, against the port's exact search

@pytest.mark.parametrize("n,count,k,exclude_self,ties", [
    (512, 500, 16, True, False),
    (300, 300, 9, False, False),
    (64, 10, 16, True, False),  # fewer points than k + 1: phantom neighbours
    (512, 500, 16, True, True),
    (300, 300, 9, False, True),
])
def test_approx_knn_matches_jax(n, count, k, exclude_self, ties):
    """Without ties JAX's approx kNN gives the port's indices exactly and
    its distances within tolerance (JAX's own exact search rounds them as
    its approx one does, bit for bit). With duplicated points both return
    the k nearest with recall 1.0, the same distances in every row, but
    approx_min_k's CPU sort is not stable: inside a run of equal
    distances its order is not lax.top_k's lower index first, which the
    port keeps (JAX's exact order)."""
    rng = np.random.RandomState(n + k)
    keys = np.zeros((n, 3), np.float32)
    keys[:count] = rng.rand(count, 3)
    if ties:
        keys[1:count:2] = keys[0:count - 1:2]
    queries = keys if exclude_self else rng.rand(200, 3).astype(np.float32)
    if ties and not exclude_self:
        queries[:50] = keys[:50]
    ai, ad = jn.masked_knn(queries, keys, count, k, exclude_self=exclude_self, method="approx")
    ei, ed = jn.masked_knn(queries, keys, count, k, exclude_self=exclude_self, method="exact")
    ti, td = tn.masked_knn(_t(queries), _t(keys), torch.tensor(count), k,
                           exclude_self=exclude_self)
    ai, ad, ei, ed = map(np.asarray, (ai, ad, ei, ed))
    np.testing.assert_array_equal(ad, ed)
    np.testing.assert_allclose(td.numpy(), ad, **TOL)
    np.testing.assert_array_equal(ti.numpy(), ei)
    if not ties:
        np.testing.assert_array_equal(ti.numpy(), ai)
        return
    assert (ti.numpy() != ai).any()  # the tie order differs ...
    # ... and nothing else: each row's neighbours at equal distances
    rows = np.arange(ai.shape[0])[:, None]
    d2 = ((queries[:, None, :] - keys[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.sort(d2[rows, ti.numpy()], 1), np.sort(d2[rows, ai], 1))


def test_knn_method_values():
    tn.check_knn_method("exact")
    tn.check_knn_method("approx")
    with pytest.raises(ValueError, match="knn_method"):
        tn.check_knn_method("ball")


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_every_repo_config_builds_the_model(path):
    """Every config the repo ships (knn_method approx in the test configs)
    builds the port's model with no override."""
    from roitr_torch.config import load_config
    from roitr_torch.models.roitr import RoITr

    cfg = load_config(path)
    model = RoITr(cfg, device="cpu")
    assert cfg.knn_method in ("exact", "approx")
    assert model.backbone.global_transformer.in_proj.out_features == 256 * cfg.channel_factor


# ---- the Sinkhorn convergence exit and backend "xla"

def _patches(seed, b=6, m=16, n=14):
    """Scores and masks of b patches with masked rows and columns, and one
    patch masked whole (a fixed-capacity buffer's empty slot)."""
    rng = np.random.RandomState(seed)
    scores = (rng.randn(b, m, n) * 2.0).astype(np.float32)
    rm = rng.rand(b, m) > 0.25
    cm = rng.rand(b, n) > 0.25
    rm[-1] = False
    cm[-1] = False
    return scores, rm, cm


@pytest.mark.parametrize("tol", [1e-3, 1e-5])
def test_sinkhorn_early_exit_matches_jax(tol):
    """JAX's while_loop exit (backend "xla") against the port's CPU path,
    which takes the exit under either backend: the loop stops before
    num_iter, at the iteration where JAX's stops (JAX's result equals its
    fixed-count loop of that many iterations)."""
    scores, rm, cm = _patches(3)
    alpha = np.float32(0.7)
    want = np.asarray(jax_log_sinkhorn_ot(jnp.asarray(scores), jnp.asarray(rm),
                                          jnp.asarray(cm), jnp.asarray(alpha), num_iter=100,
                                          backend="xla", tol=tol))
    for backend in ("pallas", "xla"):
        got = log_sinkhorn_ot(_t(scores), _t(rm), _t(cm), torch.tensor(alpha), num_iter=100,
                              tol=tol, backend=backend).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    padded, log_mu, log_nu, _ = sinkhorn_inputs(_t(scores), _t(rm), _t(cm), torch.tensor(alpha))
    _, iters = sinkhorn_early_exit(padded, log_mu, log_nu, 100, tol)
    assert 1 < iters < 100
    fixed = np.asarray(jax_log_sinkhorn_ot(jnp.asarray(scores), jnp.asarray(rm),
                                           jnp.asarray(cm), jnp.asarray(alpha), num_iter=iters,
                                           backend="xla"))
    np.testing.assert_allclose(want, fixed, rtol=0, atol=1e-6)
    longer = log_sinkhorn_ot(_t(scores), _t(rm), _t(cm), torch.tensor(alpha), num_iter=100)
    assert not np.allclose(longer.numpy(), want, rtol=0, atol=1e-7)


def test_sinkhorn_exit_caps_at_num_iter_and_xla_is_the_plain_loop():
    """tol 0 or an exit later than num_iter gives the fixed count; backend
    "xla" without tol is the plain loop, bit for bit the CPU's "pallas"
    route; an unknown backend raises."""
    scores, rm, cm = _patches(4)
    args = (_t(scores), _t(rm), _t(cm), torch.tensor(1.0))
    padded, log_mu, log_nu, _ = sinkhorn_inputs(*args)
    _, iters = sinkhorn_early_exit(padded, log_mu, log_nu, 7, 1e-12)
    assert iters == 7
    fixed = log_sinkhorn_ot(*args, num_iter=7)
    assert torch.equal(log_sinkhorn_ot(*args, num_iter=7, tol=1e-12), fixed)
    assert torch.equal(log_sinkhorn_ot(*args, num_iter=7, backend="xla"), fixed)
    want = np.asarray(jax_log_sinkhorn_ot(*(jnp.asarray(a) for a in (scores, rm, cm)),
                                          jnp.float32(1.0), num_iter=7, backend="xla"))
    np.testing.assert_allclose(fixed.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="backend"):
        log_sinkhorn_ot(*args, num_iter=7, backend="triton")


def test_model_backend_values():
    from roitr_torch.config import Config
    from roitr_torch.models.roitr import RoITr

    RoITr(Config(sinkhorn_backend="xla", knn_method="approx"), device="cpu")
    with pytest.raises(ValueError, match="sinkhorn_backend"):
        RoITr(Config(sinkhorn_backend="triton"), device="cpu")
    with pytest.raises(ValueError, match="knn_method"):
        RoITr(Config(knn_method="ball"), device="cpu")


# ---- models/ppf_transformer.py

@pytest.mark.parametrize("with_cross_pos_embed", [True, False])
def test_ppf_transformer_matches_jax(with_cross_pos_embed):
    """Width 32, 4 heads, blocks self/cross/self/cross, seeded JAX weights
    carried across by ppf_params_to_state_dict; without and with masks
    (fully masked trailing nodes)."""
    from roitr_torch.models.ppf_transformer import PPFTransformer
    from roitr_torch.utils.convert import ppf_params_to_state_dict
    from roitr_tpu.models.ppf_transformer import PPFTransformer as JaxPPFTransformer

    rng = np.random.RandomState(11)
    n, m, c, d = 12, 10, 32, 32
    blocks = ("self", "cross", "self", "cross")
    arrays = (rng.randn(n, c).astype(np.float32), rng.randn(m, c).astype(np.float32),
              rng.rand(n, n, 4).astype(np.float32), rng.rand(m, m, 4).astype(np.float32))
    jmod = JaxPPFTransformer(c, c, d, 4, blocks, with_cross_pos_embed=with_cross_pos_embed)
    # seeded weights in the shapes of JAX's params (eval_shape compiles nothing)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *map(jnp.asarray, arrays))
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)),
        shapes["params"])
    model = PPFTransformer(c, c, d, 4, blocks, with_cross_pos_embed)
    model.load_state_dict(ppf_params_to_state_dict(params, blocks, with_cross_pos_embed))
    masks = (np.arange(n) < n - 2, np.arange(m) < m - 1)
    for mk in ((None, None), masks):
        want = jmod.apply({"params": params}, *map(jnp.asarray, arrays),
                          *(None if x is None else jnp.asarray(x) for x in mk))
        with torch.no_grad():
            got = model(*map(_t, arrays), *(None if x is None else _t(x) for x in mk))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---- ops/legacy.py

def test_legacy_ops_match_jax():
    from roitr_torch.ops import legacy as tl
    from roitr_tpu.ops import legacy as jl

    rng = np.random.RandomState(12)
    log_alpha = rng.randn(2, 5, 7).astype(np.float32)
    for slack in (True, False):
        np.testing.assert_allclose(
            tl.sinkhorn(_t(log_alpha), n_iters=4, slack=slack).numpy(),
            np.asarray(jl.sinkhorn(jnp.asarray(log_alpha), n_iters=4, slack=slack)), rtol=0,
            atol=1e-5)
    b, n, m = 2, 8, 9
    src, tgt = rng.rand(b, n, 3).astype(np.float32), rng.rand(b, m, 3).astype(np.float32)
    sf, tf = rng.randn(b, n, 4).astype(np.float32), rng.randn(b, m, 4).astype(np.float32)
    got = tl.soft_assignment(_t(src), _t(sf), _t(tgt), _t(tf))
    want = jl.soft_assignment(*map(jnp.asarray, (src, sf, tgt, tf)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    w = rng.rand(b, n, m).astype(np.float32)
    np.testing.assert_allclose(tl.interpolate(_t(w), _t(tgt)).numpy(),
                               np.asarray(jl.interpolate(jnp.asarray(w), jnp.asarray(tgt))),
                               rtol=0, atol=1e-5)


# ---- data/patches.py

def test_patch_helpers_bit_equal_to_jax():
    """Each helper on the same inputs and RandomState streams as JAX's."""
    from roitr_torch.data import patches as tp
    from roitr_tpu.data import patches as jp

    pts = np.random.RandomState(13).rand(300, 3).astype(np.float32)
    nodes = pts[::40]
    nrm = np.random.RandomState(14).randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    gsel = np.random.RandomState(15).randint(0, 300, (8, 5))
    calls = (
        ("ball_query_patches", lambda mod, r: mod.ball_query_patches(pts, nodes, 0.25, 12, rng=r)),
        ("point2node_sampling", lambda mod, r: mod.point2node_sampling(pts, nodes, 16, rng=r)),
        ("calc_ppf_np", lambda mod, r: mod.calc_ppf_np(pts[:8], nrm[:8], pts[gsel], nrm[gsel])),
        ("random_crop", lambda mod, r: mod.random_crop(pts, 0.7, r)),
        ("x_axis_crop", lambda mod, r: mod.x_axis_crop(pts, 0.5)),
    )
    for name, call in calls:
        got = call(tp, np.random.RandomState(7))
        want = call(jp, np.random.RandomState(7))
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---- utils/factory.py

def test_factory_layers_match_jax_registries():
    from roitr_torch.utils import factory as tf
    from roitr_tpu.utils import factory as jf

    grid = np.linspace(-25.0, 25.0, 2001, dtype=np.float32)
    assert set(tf.ACT_LAYERS) == set(jf.ACT_LAYERS)
    for name in tf.ACT_LAYERS:
        got = tf.build_act_layer(name)(_t(grid)).numpy()
        np.testing.assert_allclose(got, np.asarray(jf.build_act_layer(name)(jnp.asarray(grid))),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert isinstance(tf.build_act_layer(None), torch.nn.Identity)

    rng = np.random.RandomState(16)
    x = rng.randn(6, 5, 32).astype(np.float32) * 3.0 + 1.0
    scale, bias = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    for name in ("LayerNorm", "GroupNorm", "None"):
        layer = tf.build_norm_layer(name, 32)
        jlayer = jf.build_norm_layer(name, 32)
        if name == "None":
            assert torch.equal(layer(_t(x)), _t(x)) and np.array_equal(jlayer(x), x)
            continue
        with torch.no_grad():
            layer.weight.copy_(_t(scale))
            layer.bias.copy_(_t(bias))
            got = layer(_t(x)).numpy()
        want = jlayer.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                            jnp.asarray(x))
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6, err_msg=name)

    assert isinstance(tf.build_dropout_layer(None), torch.nn.Identity)
    assert isinstance(tf.build_dropout_layer(0.0), torch.nn.Identity)
    drop = tf.build_dropout_layer(0.5).eval()
    assert torch.equal(drop(_t(x)), _t(x))  # deterministic outside training, as JAX's default
    for build, arg in ((tf.build_act_layer, "Swish"), (tf.build_norm_layer, "BatchNorm")):
        with pytest.raises(ValueError, match="unknown"):
            build(arg) if build is tf.build_act_layer else build(arg, 8)


# ---- utils/profiling.py

def test_profiling_trace_names_the_annotated_region(tmp_path):
    from roitr_torch.utils.profiling import annotate, log_elapsed, trace
    from roitr_tpu.utils.profiling import log_elapsed as jax_log_elapsed

    with trace(str(tmp_path / "profiles")) as log_dir:
        with annotate("roitr_region"):
            torch.ones(64).cumsum(0)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "roitr_region" for e in events)

    msgs = []
    for fn in (log_elapsed, jax_log_elapsed):
        with fn("step", printer=msgs.append):
            pass
    assert len(msgs) == 2 and all(re.fullmatch(r"step: \d+\.\dms", m) for m in msgs)
