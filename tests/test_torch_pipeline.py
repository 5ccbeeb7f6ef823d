"""The port's slice as a whole against the JAX package on the CPU, same
weights, same seeded inputs: the backbone (RIPointTransformer),
RoITr.forward(with_gt=False) key by key, and Matcher.match on raw clouds;
plus the rotation invariance of the port's node descriptors.

fp32 embedding storage in both packages: fp32 outputs within rtol 1e-4 /
atol 1e-5, index outputs exactly. bf16 storage (the default): node
descriptors need cosine >= 0.999, the JAX package's own bf16 budget
(roitr_tpu/models/transformer.py:33-41). The JAX side runs op by op: a
jitted program fuses and rounds differently (measured up to 1.2e-4 on
point features on the CPU). Every JAX run here is at the 512 bucket, so the
op-by-op programs compiled for the first one serve the others.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.data.preprocess import estimate_normals_np, normal_redirect_np
from roitr_torch.data.synthetic import make_pair_arrays
from roitr_torch.serving import Matcher
from roitr_tpu.models.backbone import RIPointTransformer
from roitr_tpu.models.roitr import RoITr as JaxRoITr
from roitr_tpu.serving import Matcher as JaxMatcher

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    jax_pair,
    one_torch_thread,
    pair_arrays,
    port_and_params,
    same_correspondences,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
BUCKET = dict(bucket=512, n_valid=480, m_valid=400)


def _run_both(storage: str, seed: int = 5, **cfg_kw):
    tcfg, model, jcfg, params = port_and_params(0, geo_embedding_storage=storage, **cfg_kw)
    arr = pair_arrays(seed, **BUCKET)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch_pair(arr)).items()}
    want = JaxRoITr(jcfg).apply({"params": params}, jax_pair(arr), train=False, with_gt=False)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def fp32_outputs():
    return _run_both("fp32")


def test_backbone():
    """RIPointTransformer on a seeded pair: FPS nodes and counts exactly,
    features within tolerance (a cut architecture keeps the JAX run short)."""
    arch, enc_blocks = ("self", "cross"), (2, 1, 1, 2)
    tcfg, model, jcfg, params = port_and_params(
        0, geo_embedding_storage="fp32", transformer_architecture=arch, enc_blocks=enc_blocks)
    arr = pair_arrays(3, **BUCKET)
    names = ("src_points", "src_normals", "src_feats", "src_count", "tgt_points", "tgt_normals",
             "tgt_feats", "tgt_count", "src_points")
    targs = [torch.from_numpy(arr[k]) if arr[k].ndim else torch.tensor(int(arr[k])) for k in names]
    with torch.no_grad():
        got = model.backbone(*targs)
    jmod = RIPointTransformer(transformer_blocks=arch, enc_blocks=enc_blocks,
                              geo_embedding_storage="fp32")
    want = jmod.apply({"params": params["backbone"]}, *[jnp.asarray(arr[k]) for k in names])
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=f"output {i}", **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


def test_forward_keys_match_jax(fp32_outputs):
    got, want = fp32_outputs
    assert set(got) == set(want)


@pytest.mark.parametrize("key", [
    "src_points", "tgt_points", "src_nodes", "tgt_nodes", "src_node_feats", "tgt_node_feats",
    "src_point_feats", "tgt_point_feats", "src_node_count", "tgt_node_count",
    "tgt_node_corr_indices", "src_node_corr_indices", "node_corr_masks",
    "src_node_corr_knn_points", "tgt_node_corr_knn_points", "src_node_corr_knn_masks",
    "tgt_node_corr_knn_masks", "matching_scores", "gt_node_corr_indices", "gt_node_corr_masks",
])
def test_forward_output_matches_jax(fp32_outputs, key):
    got, want = fp32_outputs
    g, w = got[key], want[key]
    assert g.shape == w.shape, key
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


def _fine_set(out):
    """Kept fine correspondences as rows [tgt xyz, src xyz, score], sorted.
    Slot order within a row's top-k follows near-equal logits, which the
    two packages may round in either order, so the set is compared."""
    keep = out["corr_masks"]
    rows = np.concatenate([out["tgt_corr_points"][keep], out["src_corr_points"][keep],
                           out["corr_scores"][keep][:, None]], axis=1)
    return rows[np.lexsort(rows[:, :6].T[::-1])]


def test_fine_correspondences_match_jax(fp32_outputs):
    got, want = fp32_outputs
    for key in ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks"):
        assert got[key].shape == want[key].shape, key
    g, w = _fine_set(got), _fine_set(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g[:, :6], w[:, :6])
    np.testing.assert_allclose(g[:, 6], w[:, 6], **TOL)


def test_forward_with_sinkhorn_tol_matches_jax(monkeypatch):
    """sinkhorn_tol > 0 at inference: JAX's CPU forward takes its
    while_loop exit (the Pallas kernel runs only on a TPU), and so does the
    port's CPU forward, stopping before sinkhorn_iters (at 53 of 100 here;
    an exit one iteration apart would move the OT scores by about tol, far
    past their tolerance); every output matches as in the fixed-count
    forward above, the kept fine correspondences as sets up to near-ties."""
    from roitr_torch.ops import sinkhorn as ops_sinkhorn

    iters = []
    real = ops_sinkhorn.sinkhorn_early_exit

    def spy(*args):
        out, n = real(*args)
        iters.append(n)
        return out, n

    monkeypatch.setattr(ops_sinkhorn, "sinkhorn_early_exit", spy)
    got, want = _run_both("fp32", sinkhorn_iters=100, sinkhorn_tol=1e-3)
    assert len(iters) == 1 and 1 < iters[0] < 100, iters
    assert set(got) == set(want)
    for key, w in want.items():
        if key in ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks"):
            continue
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[key], w, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(got[key].astype(np.int64), w.astype(np.int64), key)
    # 53 iterations leave a sharper plan than the fixed test's 10, whose
    # top-k near-ties round either way in a few rows (torch_parity)
    same_correspondences(*(tuple(o[k][o["corr_masks"]] for k in (
        "src_corr_points", "tgt_corr_points", "corr_scores")) for o in (got, want)), "tol")


def test_bf16_storage_node_descriptors_within_budget():
    got, want = _run_both("bf16")
    for side in ("src", "tgt"):
        n = int(want[f"{side}_node_count"])
        g, w = got[f"{side}_node_feats"][:n], want[f"{side}_node_feats"][:n]
        cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
        assert cos.min() >= 0.999, (side, cos.min())


def test_node_descriptors_rotation_invariant():
    """Rotating the source cloud (points and normals) leaves the node
    descriptors unchanged: PPFs are the only geometric input."""
    tcfg, model, _, _ = port_and_params(0)
    arr = pair_arrays(7, **BUCKET)
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    q = q.astype(np.float32)
    rot = dict(arr)
    rot["src_points"] = rot["src_raw_points"] = arr["src_points"] @ q.T
    rot["src_normals"] = arr["src_normals"] @ q.T
    with torch.no_grad():
        out0 = model(torch_pair(arr))
        out1 = model(torch_pair(rot))
    n = int(out0["src_node_count"])
    cos = (out0["src_node_feats"][:n] * out1["src_node_feats"][:n]).sum(-1)
    assert float(cos.min()) > 0.999, float(cos.min())


@pytest.mark.parametrize("option", [dict(compute_dtype="bfloat16"), dict(remat_local=True),
                                    dict(packed_batch=True)])
def test_later_slices_raise(option):
    """The options of later slices build, with the reference state_dict
    keys, and take their path: bf16 compute puts every Linear and LayerNorm
    of the backbone and the global transformer in bf16 and leaves the
    geometric embedding, the RPE attention's factored projections and the
    descriptor projections in fp32 (tests/test_torch_bf16.py holds it
    against JAX); remat_local recomputes every local PPF transformer
    (tests/test_torch_train_model.py); packed batches build. A packed pair
    without its pyramids raises the JAX package's ValueError (the searches
    are per cloud)."""
    from roitr_torch.config import Config
    from roitr_torch.models.backbone import PointTransformerLayer, TransitionDown
    from roitr_torch.models.layers import LayerNorm, Linear
    from roitr_torch.models.roitr import RoITr

    model = RoITr(Config(benchmark="3DMatch", **option), device="cpu")
    assert list(model.state_dict()) == list(
        RoITr(Config(benchmark="3DMatch"), device="cpu").state_dict())
    dtypes = {n: m.compute_dtype for n, m in model.named_modules()
              if isinstance(m, (Linear, LayerNorm))}
    want = torch.bfloat16 if "compute_dtype" in option else torch.float32
    assert dtypes and set(dtypes.values()) == {want}
    assert all(n.startswith("backbone.") and ".embedding.proj_" not in n for n in dtypes)
    remat = [m.remat for m in model.modules()
             if isinstance(m, (TransitionDown, PointTransformerLayer))]
    # four down-samplings, the encoder's 1 + 2 + 2 + 2 blocks and the decoder's 4
    assert len(remat) == 15 and all(remat) == ("remat_local" in option)
    tcfg, model, _, _ = port_and_params(0)
    pair = torch_pair(pair_arrays(1))
    batched = pair._replace(src_count=torch.tensor([224]), tgt_count=torch.tensor([192]))
    with pytest.raises(ValueError, match="packed batches require host-precomputed"):
        model(batched)


@pytest.mark.parametrize("option", [dict(knn_method="approx"), dict(sinkhorn_backend="xla"),
                                    dict(compute_dtype="float16"), dict(remat_local=True),
                                    dict(knn_method="ball"), dict(sinkhorn_backend="triton")])
def test_unported_options_raise(option):
    """Values no path takes are refused when the model is built, not
    followed silently: a compute dtype other than float32 and bfloat16
    (JAX's Config quietly computes those in float32), a kNN method or a
    Sinkhorn backend the JAX package does not name. The options once
    refused here are ported, and on the CPU their forward equals the
    default model's bit for bit: knn_method "approx" (the exact search,
    as XLA computes approx_min_k off the TPU), sinkhorn_backend "xla" (the
    plain loop, which the CPU runs under "pallas" too) and remat_local,
    with a graph (the checkpointed transformers) and without."""
    from roitr_torch.config import Config
    from roitr_torch.models.roitr import RoITr

    if option in (dict(knn_method="approx"), dict(sinkhorn_backend="xla"),
                  dict(remat_local=True)):
        _, plain, _, _ = port_and_params(0)
        _, other, _, _ = port_and_params(0, **option)
        pair = torch_pair(pair_arrays(1, 128, 112, 96))
        with torch.no_grad():
            want = plain(pair)
            got_no_graph = other(pair)
        got = other(pair)
        for key, w in want.items():
            assert torch.equal(got[key].detach(), w) and torch.equal(got_no_graph[key], w), key
        return
    with pytest.raises(ValueError, match=next(iter(option))):
        RoITr(Config(benchmark="3DMatch", **option), device="cpu")


# ---- Matcher.match on raw clouds. The JAX package estimates normals with
# its native KD-tree when built, the port with scipy, so the parity test
# hands the same normals to both.

@pytest.fixture(scope="module")
def matchers():
    tcfg, model, jcfg, params = port_and_params(0, geo_embedding_storage="fp32")
    return (Matcher(tcfg, model.state_dict(), device="cpu", descriptors=True),
            JaxMatcher(jcfg, params, descriptors=True))


def _clouds(seed, n, m):
    rng = np.random.RandomState(seed)
    arr = make_pair_arrays(rng, max(n, m), n, m)
    src, tgt = arr["src_points"][:n], arr["tgt_points"][:m]
    view = np.zeros(3, np.float32)
    return (src, tgt, normal_redirect_np(src, estimate_normals_np(src, 9), view),
            normal_redirect_np(tgt, estimate_normals_np(tgt, 9), view))


def _corr_set(out):
    """{(src xyz, tgt xyz): confidence} of the kept correspondences."""
    keys = np.concatenate([out["src_corr_pts"], out["tgt_corr_pts"]], axis=1)
    return {tuple(k): c for k, c in zip(keys.tolist(), out["confidence"].tolist())}


def test_match_matches_jax(matchers, monkeypatch):
    """(600, 540) points is above points_limit=512: both packages cap each
    cloud with the same RandomState(0) permutation, normals riding along.
    Nodes exactly; descriptors within tolerance; the kept correspondences
    as a set. With random weights many point descriptors are nearly equal,
    so a few row top-k decisions fall on near-ties (two partners whose
    confidences differ by ~1e-7) that the two packages round either way:
    the (src, tgt) pairs may differ in at most 2% of their union, while the
    sorted confidences agree within tolerance, count included."""
    port, ref = matchers
    src, tgt, sn, tn = _clouds(5, 600, 540)
    got = port.match(src, tgt, sn, tn)
    # the JAX Matcher's forward runs un-jitted, as the forward tests' does
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    want = ref.match(src, tgt, sn, tn)
    assert set(got) == set(want)
    for key in ("src_nodes", "tgt_nodes"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("src_node_desc", "tgt_node_desc", "src_point_desc", "tgt_point_desc"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    np.testing.assert_allclose(np.sort(got["confidence"]), np.sort(want["confidence"]), **TOL)
    g, w = _corr_set(got), _corr_set(want)
    assert len(set(g) ^ set(w)) <= 0.02 * len(set(g) | set(w))
    shared = sorted(set(g) & set(w))
    np.testing.assert_allclose([g[k] for k in shared], [w[k] for k in shared], **TOL)


def test_match_estimates_normals_and_trims(matchers):
    port, _ = matchers
    src, tgt, _, _ = _clouds(11, 250, 230)
    out = port.match(src, tgt)
    assert out["src_point_desc"].shape == (250, 256)
    assert out["tgt_point_desc"].shape == (230, 256)
    assert out["src_corr_pts"].shape == out["tgt_corr_pts"].shape
    assert out["confidence"].shape == (out["src_corr_pts"].shape[0],)
    for v in out.values():
        assert np.isfinite(v).all()
    np.testing.assert_allclose(np.linalg.norm(out["src_node_desc"], axis=-1), 1.0, atol=1e-5)
