"""The port's training forward and gradients against the JAX package on
the CPU, same weights and seeded pair: RoITr.forward(with_gt=True) in
eval and train mode key by key, the losses and evaluator of each, and
every parameter's gradient of overall_loss["loss"].

Tolerances: indices exactly; fp32 values within rtol 1e-4 / atol 1e-5;
gradients within rtol 1e-3 / atol 1e-5 per parameter and cosine >= 0.9999
over all of them (about forty layers of fp32 sums in two orders). Every
JAX run is at one bucket (512) and one cut architecture (("self", "cross"),
enc_blocks (2, 1, 1, 2)) with fp32 embedding storage, in this one file so
that the op-by-op compiles are shared. Each forward runs op by op: jitted,
the JAX forward rounds differently from itself, up to 2.7x the fp32
tolerance on point features. The backward is jitted: its gradients are
within 1% of their tolerance of the op-by-op backward's, and it is one
compile in place of hundreds. Most of the file's time (about 110 s on one
core) is XLA compiling some 1500 small programs for the op-by-op JAX runs.
"""

import numpy as np
import jax
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.losses import evaluate, overall_loss
from roitr_torch.utils.convert import params_to_state_dict
from roitr_tpu import losses as jlosses
from roitr_tpu.config import Config as JaxConfig
from roitr_tpu.models.roitr import RoITr as JaxRoITr

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    jax_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(transformer_architecture=("self", "cross"), enc_blocks=(2, 1, 1, 2))
BUCKET = dict(bucket=512, n_valid=480, m_valid=400)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, key=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, key
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=key)


def _no_valid_zero_pair(out):
    idx = _np(out["gt_node_corr_indices"])
    return not _np(out["gt_node_corr_masks"])[(idx == 0).all(1)].any()


def _assert_fine_close(got, want):
    """The kept fine correspondences as {(tgt xyz, src xyz): score}. With
    random weights the OT plans are nearly uniform, so a few top-k
    decisions fall on logits within rounding of each other, which the two
    packages may take either way (as test_torch_pipeline.py's Matcher test
    allows): the pairs may differ in at most 2% of their union, and shared
    pairs agree in score within tolerance."""
    def pairs(out):
        keep = _np(out["corr_masks"])
        keys = np.concatenate([_np(out["tgt_corr_points"])[keep],
                               _np(out["src_corr_points"])[keep]], axis=1)
        return {tuple(k): c for k, c in zip(keys.tolist(), _np(out["corr_scores"])[keep].tolist())}

    g, w = pairs(got), pairs(want)
    assert len(w) > 0
    assert len(set(g) ^ set(w)) <= 0.02 * len(set(g) | set(w))
    shared = sorted(set(g) & set(w))
    np.testing.assert_allclose([g[k] for k in shared], [w[k] for k in shared], **TOL)


_FINE = ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks")


def _tiny(**kw):
    return {**TINY, "geo_embedding_storage": "fp32", **ARCH, **kw}


@pytest.fixture(scope="module")
def eval_outputs():
    _, model, jcfg, params = port_and_params(0, geo_embedding_storage="fp32", **ARCH)
    arr = pair_arrays(5, **BUCKET)
    with torch.no_grad():
        got = model(torch_pair(arr), train=False, with_gt=True)
    want = JaxRoITr(jcfg).apply({"params": params}, jax_pair(arr), train=False, with_gt=True)
    return got, want


def test_forward_with_gt_matches_jax(eval_outputs):
    got, want = eval_outputs
    assert set(got) == set(want)
    assert int(got["gt_node_corr_masks"].sum()) > 0 and float(got["gt_tgt_node_occ"].max()) > 0
    for key in sorted(set(want) - set(_FINE)):
        _assert_same(got[key], want[key], key)
    _assert_fine_close(got, want)


def test_eval_losses_match_jax(eval_outputs):
    """overall_loss and evaluate of the validation path: each package on its
    own forward, and IR, which counts the fine correspondences (see
    _assert_fine_close), also with both packages reading JAX's forward."""
    got, want = eval_outputs
    assert _no_valid_zero_pair(want)
    arr = pair_arrays(5, **BUCKET)
    cfg, jcfg = Config(**_tiny()), JaxConfig(**_tiny())
    rot, trans = torch.from_numpy(arr["rot"]), torch.from_numpy(arr["trans"])
    g = {**overall_loss(cfg, got, rot, trans), **evaluate(cfg, got, rot, trans)}
    w = {**jlosses.overall_loss(jcfg, want, arr["rot"], arr["trans"]),
         **jlosses.evaluate(jcfg, want, arr["rot"], arr["trans"])}
    assert set(g) == set(w)
    for k in sorted(set(g) - {"IR"}):
        _assert_same(g[k], w[k], k)
    assert abs(float(g["IR"]) - float(w["IR"])) <= 0.02
    on_jax = {k: torch.from_numpy(np.array(v)) for k, v in want.items()}
    _assert_same(evaluate(cfg, on_jax, rot, trans)["IR"], w["IR"], "IR on JAX's forward")


TRAIN_KW = dict(geo_embedding_storage="fp32", num_gt_coarse_corr=64, **ARCH)


@pytest.fixture(scope="module")
def train_runs():
    """One train-mode forward and backward in each package, same weights;
    num_gt_coarse_corr >= max_gt_corr_candidates, so every eligible GT pair
    is a patch and only the patch order depends on the noise."""
    tcfg, model, jcfg, params = port_and_params(0, **TRAIN_KW)
    arr = pair_arrays(5, **BUCKET)
    tpair = torch_pair(arr)
    out = model(tpair, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = overall_loss(tcfg, out, tpair.rot, tpair.trans)
    losses["loss"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    jpair = jax_pair(arr)

    def jloss(p):
        o = JaxRoITr(jcfg).apply({"params": p}, jpair, train=True, with_gt=True,
                                 rngs={"sampling": jax.random.PRNGKey(0)})
        ls = jlosses.overall_loss(jcfg, o, jpair.rot, jpair.trans)
        return ls["loss"], (o, ls)

    # the forward op by op (its outputs are held at rtol 1e-4), the backward
    # jitted (one compile in place of hundreds of small ones)
    loss, vjp, (jout, jls) = jax.vjp(jloss, params, has_aux=True)
    (jgrads,) = jax.jit(lambda f, ct: f(ct))(vjp, jax.numpy.ones_like(loss))
    jgrads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                  transformer_architecture=ARCH["transformer_architecture"],
                                  enc_blocks=ARCH["enc_blocks"])
    return dict(out=out, losses=losses, grads=grads, jout=jout, jlosses=jls, jgrads=jgrads)


def _patch_order(out):
    """Patches sorted by their content (the points of a patch name its node
    pair); the two packages draw different Gumbel noise."""
    p = _np(out["tgt_node_corr_knn_points"]).shape[0]
    keys = np.concatenate([_np(out["tgt_node_corr_knn_points"]).reshape(p, -1),
                           _np(out["src_node_corr_knn_points"]).reshape(p, -1),
                           _np(out["tgt_node_corr_knn_masks"]).reshape(p, -1),
                           _np(out["src_node_corr_knn_masks"]).reshape(p, -1)], axis=1)
    return np.lexsort(keys.T[::-1])


def test_train_forward_matches_jax(train_runs):
    got, want = train_runs["out"], train_runs["jout"]
    assert set(got) == set(want)
    assert int(got["gt_node_corr_masks"].sum()) > 0
    per_patch = ("src_node_corr_knn_points", "tgt_node_corr_knn_points",
                 "src_node_corr_knn_masks", "tgt_node_corr_knn_masks", "matching_scores")
    for key in sorted(set(want) - set(_FINE) - set(per_patch)):
        _assert_same(got[key], want[key], key)
    og, ow = _patch_order(got), _patch_order(want)
    for key in per_patch:
        _assert_same(_np(got[key])[og], np.asarray(want[key])[ow], key)
    _assert_fine_close(got, want)


def test_train_losses_match_jax(train_runs):
    assert _no_valid_zero_pair(train_runs["jout"])
    for k in ("loss", "c_loss", "f_loss", "o_loss"):
        _assert_same(train_runs["losses"][k], train_runs["jlosses"][k], k)


def test_gradients_match_jax(train_runs):
    got, want = train_runs["grads"], train_runs["jgrads"]
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
    g = np.concatenate([got[k].ravel() for k in sorted(want)]).astype(np.float64)
    w = np.concatenate([want[k].numpy().ravel() for k in sorted(want)]).astype(np.float64)
    assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999
    assert np.linalg.norm(w) > 0
