"""bf16 compute (`compute_dtype="bfloat16"`) of the port against the JAX
package's on the CPU: same weights, same seeded pair, one bucket (256) and
one cut architecture (("self", "cross"), enc_blocks (1, 1, 1, 1): one
block a level, the decoder's four PointBlocks, one self and one cross
layer).

Under bf16 compute every Linear and LayerNorm of the backbone and of the
global transformer computes in bf16 from fp32 parameters; geometry, the
geometric embedding, the descriptor projections, the OT and the losses
stay fp32. The JAX side is one jitted `value_and_grad` of the train loss
(its forward outputs ride along as aux), compiled once (about 40 s on one
core, tracing included) in place of hundreds of op-by-op programs. Jitted, XLA keeps
fused elementwise chains in fp32 where the port rounds each op to bf16,
so the port's bf16 outputs are about as far from JAX's bf16 outputs as
from the fp32 ones (descriptor row cosines 0.99995 either way). Where
each package rounds is therefore held apart: every Linear and LayerNorm
the forward calls has the output dtype of its flax twin
(`capture_intermediates`), which fp32 everywhere or bf16 everywhere would
fail.

Tolerances, in bf16 terms (8 significant bits, a relative rounding of
2^-9 a step, some twenty steps deep):
- descriptors: every valid row's cosine with JAX's bf16 row >= 0.999
  (JAX's own bound against fp32, tests/test_bf16.py, is 0.98; the port's
  bf16 rows are within 0.98 of its fp32 rows too), and the largest
  difference from JAX's bf16 rows at most 3% of their largest value
  (measured 1.1%; the fp32 rows are 1.2% off JAX's bf16 rows);
- matching scores (log-domain OT plans): within 0.05 + 1% (near-uniform
  plans, about -4 in the valid block);
- losses: within 0.2%;
- gradients of the train loss: cosine over all parameters >= 0.995, and
  each parameter within 3% of the global gradient norm. With a node level
  of 4 nodes some gradients are cancellations of bf16-rounded terms: JAX's
  own jitted and op-by-op bf16 gradients of the global transformer's first
  feed-forward layer have a cosine of 0.875 (global 0.9993).
Indices (GT node correspondences, coarse matching) exactly, the patches
set-equal (the GT sampler saturated, so the two packages' different Gumbel
noise only orders them).
"""

import os

import numpy as np
import jax
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch import nn

from roitr_torch.config import Config
from roitr_torch.data.packing import attach_pyramids, pack_pairs
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.eval.tester import Tester as PortTester
from roitr_torch.losses import overall_loss
from roitr_torch.parallel.train_step import make_optimizer, train_step
from roitr_torch.serving import Matcher
from roitr_torch.utils.convert import _entries, params_to_state_dict
from roitr_tpu import losses as jlosses
from roitr_tpu.models.roitr import RoITr as JaxRoITr

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    jax_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    torch_pair,
)

ARCH = dict(transformer_architecture=("self", "cross"), enc_blocks=(1, 1, 1, 1))
KW = dict(num_gt_coarse_corr=64, **ARCH)
BF16 = dict(compute_dtype="bfloat16", **KW)
BUCKET = dict(bucket=256, n_valid=224, m_valid=192)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_layer_dtypes(model, fn):
    """{module name: set of output dtypes} of every Linear and LayerNorm
    that `fn()` calls."""
    seen, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.LayerNorm)):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: seen.setdefault(name, set()).add(o.dtype)))
    try:
        result = fn()
    finally:
        for h in hooks:
            h.remove()
    return seen, result


def _jax_layer_dtypes(intermediates):
    """{flax module path: set of output dtype names} of captured calls."""
    flat = flatten_dict(intermediates)
    return {k[:-1]: {str(v.dtype) for v in vals} for k, vals in flat.items()
            if k[-1] == "__call__" and all(hasattr(v, "dtype") for v in vals)}


def _train_run(model, cfg, arr):
    """One train-mode forward with the GT analysis, its losses and backward:
    (outputs, losses, {name: gradient})."""
    pair = torch_pair(arr)
    out = model(pair, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = overall_loss(cfg, out, pair.rot, pair.trans)
    losses["loss"].backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for k, p in model.named_parameters()}
    return out, losses, grads


@pytest.fixture(scope="module")
def runs():
    """The port's bf16 and fp32 train runs and JAX's bf16 one, same weights
    and pair."""
    tcfg, model, jcfg, params = port_and_params(0, **BF16)
    arr = pair_arrays(5, **BUCKET)
    dtypes, (out, losses, grads) = _port_layer_dtypes(model, lambda: _train_run(model, tcfg, arr))
    cfg32, model32, _, _ = port_and_params(0, **KW)
    out32, _, grads32 = _train_run(model32, cfg32, arr)
    jpair = jax_pair(arr)

    jdtypes = {}

    def jloss(p):
        o, state = JaxRoITr(jcfg).apply({"params": p}, jpair, train=True, with_gt=True,
                                        rngs={"sampling": jax.random.PRNGKey(0)},
                                        capture_intermediates=True)
        jdtypes.update(_jax_layer_dtypes(state["intermediates"]))  # at trace time
        ls = jlosses.overall_loss(jcfg, o, jpair.rot, jpair.trans)
        return ls["loss"], (o, ls)

    # the compile is the file's cost: with LLVM's optimisations and XLA's
    # fusion emitters off it takes about 30 s on one core in place of 60,
    # and the outputs are the same to the bit
    step = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(params).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True,
                          "xla_cpu_use_fusion_emitters": False,
                          "xla_cpu_parallel_codegen_split_count": 1})
    (_, (jout, jls)), jgrads = step(params)
    jgrads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                  transformer_architecture=ARCH["transformer_architecture"],
                                  enc_blocks=ARCH["enc_blocks"])
    return dict(cfg=tcfg, model=model, out=out, losses=losses, grads=grads, out32=out32,
                grads32=grads32, jout=jout, jlosses=jls, jgrads={k: v.numpy() for k, v in jgrads.items()},
                dtypes=dtypes, jdtypes=jdtypes)


def _rows_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _patch_order(out):
    """Patches sorted by their content (tests/test_torch_train_model.py)."""
    p = _np(out["tgt_node_corr_knn_points"]).shape[0]
    keys = np.concatenate([_np(out[k]).reshape(p, -1) for k in (
        "tgt_node_corr_knn_points", "src_node_corr_knn_points", "tgt_node_corr_knn_masks",
        "src_node_corr_knn_masks")], axis=1)
    return np.lexsort(keys.T[::-1])


def test_bf16_layer_dtypes_match_jax(runs):
    """Each Linear / LayerNorm of the port computes in the dtype of its
    flax twin (bf16 in the backbone and the global transformer, fp32 in
    the descriptor projections); pairs from the converter's key map."""
    port, jax_dtypes = runs["dtypes"], runs["jdtypes"]
    compared = {}
    for path, leaf, key, _ in _entries(ARCH["transformer_architecture"], ARCH["enc_blocks"]):
        name = key.rsplit(".", 1)[0]
        if leaf == "bias" or name not in port:
            continue
        assert path in jax_dtypes, (name, path)
        compared[name] = {str(d).replace("torch.", "") for d in port[name]}
        assert compared[name] == jax_dtypes[path], (name, path)
    assert {"bfloat16"} in compared.values() and {"float32"} in compared.values()
    assert len(compared) == len(port)  # every layer the forward called


def test_bf16_descriptors_match_jax(runs):
    got, want, fp32 = runs["out"], runs["jout"], runs["out32"]
    for side in ("src", "tgt"):
        n = int(want[f"{side}_node_count"])
        for kind, rows in (("node", n), ("point", int(want[f"{side}_count"]))):
            key = f"{side}_{kind}_feats"
            g, w = _np(got[key])[:rows], _np(want[key])[:rows]
            assert g.dtype == w.dtype == np.float32, key
            assert _rows_cos(g, w).min() >= 0.999, key
            assert np.abs(g - w).max() <= 0.03 * np.abs(w).max(), key
            assert _rows_cos(g, _np(fp32[key])[:rows]).min() >= 0.98, key


def test_bf16_indices_and_matching_scores_match_jax(runs):
    got, want = runs["out"], runs["jout"]
    assert set(got) == set(want)
    for key in ("gt_node_corr_indices", "gt_node_corr_masks", "tgt_node_corr_indices",
                "src_node_corr_indices", "node_corr_masks", "src_node_count", "tgt_node_count"):
        np.testing.assert_array_equal(_np(got[key]).astype(np.int64),
                                      _np(want[key]).astype(np.int64), err_msg=key)
    og, ow = _patch_order(got), _patch_order(want)
    g, w = _np(got["matching_scores"])[og], _np(want["matching_scores"])[ow]
    assert g.dtype == w.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=1e-2, atol=0.05)


def test_bf16_losses_match_jax(runs):
    for k in ("loss", "c_loss", "f_loss", "o_loss"):
        np.testing.assert_allclose(float(runs["losses"][k].detach()), float(runs["jlosses"][k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)


def test_bf16_gradients_match_jax(runs):
    got, want = runs["grads"], runs["jgrads"]
    assert set(got) == set(want)
    keys = sorted(want)
    g = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    w = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    norm = np.linalg.norm(w)
    assert norm > 0 and np.isfinite(g).all()
    assert np.dot(g, w) / (np.linalg.norm(g) * norm) >= 0.995
    for k in keys:
        assert np.linalg.norm(got[k] - want[k]) <= 0.03 * norm, k


def test_bf16_train_step_keeps_fp32_parameters(runs):
    """A port train step under bf16 compute: the losses finite, the
    gradients fp32 and finite, every parameter still fp32 and moved."""
    tcfg, model = runs["cfg"], runs["model"]
    model.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = train_step(model, make_optimizer(tcfg, model), torch_pair(pair_arrays(5, **BUCKET)),
                         torch.Generator().manual_seed(0))
    assert metrics["grads_finite"] == 1.0 and np.isfinite(metrics["loss"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)
    assert all(v.dtype == before[k].dtype for k, v in model.state_dict().items())
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_bf16_packed_forward_equals_single_pairs():
    """Two pairs packed (host pyramids) through the bf16 forward against the
    single-pair bf16 forwards: descriptors within 1% of their largest
    value (packed products run over other row counts and may round bf16
    products apart), node correspondences exactly."""
    tcfg, model, _, _ = port_and_params(0, **BF16)
    pairs = [attach_pyramids(torch_pair(pair_arrays(20 + i, 256, n, m)), tcfg.enc_strides,
                             tcfg.enc_nsample) for i, (n, m) in enumerate(((240, 200), (180, 256)))]
    with torch.no_grad():
        packed = model(pack_pairs(pairs), with_gt=True)
        singles = [model(p, with_gt=True) for p in pairs]
    for i, single in enumerate(singles):
        for key in ("src_node_feats", "tgt_node_feats", "src_point_feats", "tgt_point_feats"):
            g, w = _np(packed[key][i]), _np(single[key])
            assert g.dtype == np.float32
            assert np.abs(g - w).max() <= 0.01 * np.abs(w).max(), (i, key)
        for key in ("tgt_node_corr_indices", "src_node_corr_indices", "node_corr_masks"):
            np.testing.assert_array_equal(_np(packed[key][i]), _np(single[key]), err_msg=key)


def test_bf16_matcher_and_tester_run(tmp_path, monkeypatch):
    """Matcher.match and the Tester under bf16 compute on the CPU: finite
    fp32 descriptors, one dump a pair."""
    monkeypatch.chdir(tmp_path)
    tcfg, model, _, _ = port_and_params(0, **BF16)
    arr = pair_arrays(7, **BUCKET)
    n, m = int(arr["src_count"]), int(arr["tgt_count"])
    res = Matcher(tcfg, model.state_dict(), device="cpu", descriptors=True).match(
        arr["src_points"][:n], arr["tgt_points"][:m], arr["src_normals"][:n],
        arr["tgt_normals"][:m])
    assert res["src_node_desc"].dtype == np.float32 and np.isfinite(res["src_node_desc"]).all()
    cfg = Config(**{**TINY, **BF16, "buckets": (128,), "mode": "test", "num_workers": 0})
    PortTester(cfg, dataset=SyntheticPairs(2, 128, normal_knn=9), device="cpu",
           state_dict=model.state_dict()).test()
    out_dir = os.path.join("snapshot", cfg.exp_dir, cfg.benchmark)
    assert sorted(os.listdir(out_dir)) == ["0.pth", "1.pth"]
    dump = torch.load(os.path.join(out_dir, "0.pth"), weights_only=False)
    assert dump["src_node_desc"].dtype == torch.float32
    assert torch.isfinite(dump["src_node_desc"]).all()
