"""The port's non-rigid (4DMatch / 4DLoMatch) variant against the JAX
package on the CPU, the same seeded numpy inputs through both:

- `adaptive_superpoint_matching`: indices and validity exactly (the +inf
  slots of masked pairs included), scores within 1e-6.
- `make_flow_pair_arrays` bit for bit; `FDMatchDataset` in val and test
  mode (seeded by index) array for array, the point cap, metric_index,
  host pyramids and device prep included (normals within 1e-6, the rest
  exactly); its train mode (unseeded in both packages) by what it must
  keep: the deformed source lands on the target under the returned
  transform. `get_dataset`'s split mapping.
- The evaluators (`compute_nrfmr`, `compute_inlier_ratio`,
  `evaluate_fdmatch`) give JAX's values on the same dumps.
- The whole model at `channel_factor` 2 (benchmark 4DMatch: hidden 512,
  planes 128/256/512/512), `torch_parity.TINY` otherwise with the cut
  architecture of tests/test_torch_train_model.py, the 256 bucket, fp32
  embedding storage: the with-GT eval forward key by key, the packed
  forward of two flow pairs against JAX's `_forward_packed`, one train
  step's losses and every parameter's gradient, and the Tester's dumps
  against JAX's `trim_outputs` of its forward, with `evaluate_fdmatch` of
  each package's dumps. Tolerances: fp32 outputs rtol 1e-4 / atol 1e-5,
  indices exactly (the adaptive node correspondences among them);
  gradients rtol 1e-3 / atol 1e-5 and cosine >= 0.9999; kept fine
  correspondences as sets at most 2% of their union apart
  (`same_correspondences`: near-ties of random weights). Every fine
  correspondence is kept (`fine_matching_confidence_threshold` 0), so the
  sets are not empty.
- The port alone: packed Tester dumps equal single-pair ones under host
  pyramids and device prep; `Matcher` at 4DMatch (`match` equals the
  forward, `match_batch` equals `match`); `Trainer` from
  configs/train/fdmatch.yaml.

The JAX forwards run op by op (jitted, a forward rounds differently: up
to 4.3e-5 on point features here, 2.7x the tolerance at 3DMatch's 512
bucket, tests/test_torch_pipeline.py). The first compiles some 850 small
programs (about 40 s on one core); the Tester's pairs, the packed pairs'
flat point levels and the train step (its forward under jax.vjp, its
backward jitted, as in tests/test_torch_train_model.py) reuse many of
them.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roitr_torch.config import Config, load_config
from roitr_torch.data import get_dataset
from roitr_torch.data.fdmatch import FDMatchDataset, read_entries
from roitr_torch.data.packing import attach_pyramids, pack_pairs
from roitr_torch.data.synthetic import make_flow_pair_arrays
from roitr_torch.eval import Tester as PortTester
from roitr_torch.eval import evaluate_fdmatch, list_dumps, load_dump
from roitr_torch.eval.fdmatch_eval import (
    blend_anchor_motion,
    compute_inlier_ratio,
    compute_nrfmr,
)
from roitr_torch.losses import overall_loss
from roitr_torch.models.matching import adaptive_superpoint_matching
from roitr_torch.models.roitr import RoITr
from roitr_torch.serving import Matcher
from roitr_torch.train.trainer import Trainer
from roitr_torch.utils.convert import params_to_state_dict
from roitr_tpu import losses as jlosses
from roitr_tpu.config import Config as JaxConfig
from roitr_tpu.data import get_dataset as jax_get_dataset
from roitr_tpu.data.synthetic import make_flow_pair_arrays as jax_make_flow_pair_arrays
from roitr_tpu.eval import fdmatch_eval as jax_eval
from roitr_tpu.eval import tester as jax_tester
from roitr_tpu.models.matching import adaptive_superpoint_matching as jax_adaptive
from roitr_tpu.models.roitr import RoITr as JaxRoITr

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    flow_pair_arrays,
    jax_pair,
    jax_packed_pair,
    one_torch_thread,
    port_and_params,
    same_correspondences,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = dict(transformer_architecture=("self", "cross"), enc_blocks=(2, 1, 1, 2))
# a threshold of 0.3 with a minimum of 2 correspondences: the random
# weights' normalized node distances lie in 0.1-0.6, so the threshold decides
FD = dict(benchmark="4DMatch", geo_embedding_storage="fp32",
          fine_matching_confidence_threshold=0.0, num_est_coarse_corr=2,
          coarse_similarity_threshold=0.3, **ARCH)
BUCKET = 256
COUNTS = ((240, 200), (180, 256))  # the tree's pairs
FINE = ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks")


def _jax_scipy_normals(mp):
    """JAX estimates normals with its native library when it is built; the
    port's datasets take scipy normals. Under `mp`, JAX's 4DMatch dataset
    runs its own scipy path; host pyramids stay native in both (bit for bit,
    tests/test_torch_pyramid.py)."""
    import roitr_tpu.data.fdmatch
    import roitr_tpu.native
    from roitr_tpu.data.preprocess import estimate_normals_np

    def scipy_normals(points, k=33):
        with pytest.MonkeyPatch.context() as inner:
            inner.setattr(roitr_tpu.native, "available", lambda: False)
            return estimate_normals_np(points, k)

    mp.setattr(roitr_tpu.data.fdmatch, "estimate_normals_np", scipy_normals)


@pytest.fixture
def scipy_normals_in_jax(monkeypatch):
    _jax_scipy_normals(monkeypatch)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kept(out):
    keep = _np(out["corr_masks"]).astype(bool)
    return (_np(out["src_corr_points"])[keep], _np(out["tgt_corr_points"])[keep],
            _np(out["corr_scores"])[keep])


def _assert_outputs_match(got, want, tag):
    """Every key but the fine correspondences by value (indices exactly),
    those as sets of kept rows."""
    assert set(got) == set(want), tag
    for key in sorted(want):
        g, w = _np(got[key]), _np(want[key])
        assert g.shape == w.shape, (tag, key, g.shape, w.shape)
        if key in FINE:
            continue
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=f"{tag}: {key}", **TOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{tag}: {key}")
    assert int(_np(want["corr_masks"]).sum()) > 0, tag
    same_correspondences(_kept(got), _kept(want), tag)


# ---- adaptive superpoint matching ----------------------------------------------

def _unit(rng, n, c):
    x = rng.randn(n, c).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


ADAPTIVE_CASES = {  # most share one shape, so that JAX compiles once for them
    # (seed, N, M, C, src valid, tgt valid, min_num, capacity, threshold)
    "threshold": (0, 12, 10, 4, 12, 10, 4, 64, 0.75),
    "fallback": (1, 12, 10, 4, 12, 10, 6, 64, 0.05),
    "partial_masks": (2, 12, 10, 4, 7, 9, 5, 64, 0.75),
    "ties": (5, 12, 10, 4, 12, 10, 4, 64, 0.75),
    "all_masked": (6, 12, 10, 4, 0, 10, 4, 64, 0.75),
    "capacity_above_n_m": (3, 7, 5, 4, 6, 5, 3, 512, 0.9),
    "min_num_above_capacity": (4, 9, 9, 4, 9, 7, 40, 20, 0.3),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_matching_matches_jax(case):
    seed, n, m, c, nv, mv, min_num, cap, thr = ADAPTIVE_CASES[case]
    rng = np.random.RandomState(seed)
    src, tgt = _unit(rng, n, c), _unit(rng, m, c)
    if case == "ties":  # repeated rows: equal distances, ordered by index
        src[3], src[7], tgt[2] = src[1], src[1], tgt[5]
    smask, tmask = np.arange(n) < nv, np.arange(m) < mv
    got = adaptive_superpoint_matching(torch.from_numpy(src), torch.from_numpy(tgt),
                                       torch.from_numpy(smask), torch.from_numpy(tmask),
                                       min_num_correspondences=min_num, capacity=cap,
                                       similarity_threshold=thr)
    want = jax_adaptive(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(smask),
                        jnp.asarray(tmask), min_num_correspondences=min_num, capacity=cap,
                        similarity_threshold=thr)
    assert got.masks.shape == (min(cap, n * m),)
    for name in ("ref_indices", "src_indices", "masks"):
        np.testing.assert_array_equal(_np(getattr(got, name)).astype(np.int64),
                                      np.asarray(getattr(want, name)).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_allclose(_np(got.scores), np.asarray(want.scores), rtol=0, atol=1e-6)
    valid, below = int(got.masks.sum()), int(
        (np.sqrt(np.clip(2 - 2 * src @ tgt.T, 1e-12, None))[smask][:, tmask] <= thr).sum())
    assert valid == min(max(below, min_num), nv * mv, cap), case


# ---- synthetic flow pairs, the dataset and the split mapping -----------------------

def test_flow_pair_arrays_match_jax():
    got = make_flow_pair_arrays(np.random.RandomState(7), 256, 200, 180)
    want = jax_make_flow_pair_arrays(np.random.RandomState(7), 256, 200, 180)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    deformed, raw = got["src_points"][:200], got["src_raw_points"][:200]
    assert np.abs(deformed - raw).max() > 1e-3
    np.testing.assert_allclose(raw + got["flow"][:200], deformed, atol=1e-6)


def _write_tree(base, counts=COUNTS, seed=31, metric=True):
    """Flow pairs as the reference's .npz entries (s_pc, t_pc, s2t_flow,
    rot, trans, metric_index), under split/<benchmark>/<scene>/ and listed
    in a split file (the two layouts read_entries takes)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(base, "4dmatch")
    scene = os.path.join(root, "split", "4DLoMatch", "scene0")
    os.makedirs(scene)
    rel = []
    for i, (n, m) in enumerate(counts):
        arr = make_flow_pair_arrays(rng, max(n, m), n, m)
        entry = dict(s_pc=arr["src_raw_points"][:n], t_pc=arr["tgt_points"][:m],
                     s2t_flow=arr["flow"][:n], rot=arr["rot"], trans=arr["trans"])
        if metric:
            entry["metric_index"] = np.arange(0, n, 5)[None]
        np.savez(os.path.join(scene, f"pair{i}.npz"), **entry)
        rel.append(f"split/4DLoMatch/scene0/pair{i}.npz")
    split = os.path.join(base, "split.txt")
    with open(split, "w") as f:
        f.write("\n".join(rel) + "\n")
    return dict(root=root, split=split)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("fdmatch")))


def _data_cfg(tree, **kw):
    return {**TINY, "dataset": "fdmatch", "benchmark": "4DMatch", "root": tree["root"],
            "train_info": tree["split"], "val_info": tree["split"],
            "test_info": "split/4DLoMatch", **kw}


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("_pyramid"):
            for name in w._fields:
                np.testing.assert_array_equal(getattr(got[k], name), getattr(w, name),
                                              err_msg=f"{k}.{name}")
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("_normals"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("mode,kw", [
    ("val", {}), ("test", {}), ("val", dict(points_limit=190)),
    ("test", dict(host_pyramid=True)), ("test", dict(device_prep=True))])
def test_fdmatch_dataset_matches_jax(tree, scipy_normals_in_jax, mode, kw):
    cfg = _data_cfg(tree, **kw)
    got, want = get_dataset(Config(**cfg), mode), jax_get_dataset(JaxConfig(**cfg), mode)
    assert len(got) == len(want) == len(COUNTS)
    for i in range(len(got)):
        a, b = got[i], want[i]
        _assert_items_equal(a, b)
        n = int(a["src_count"])
        assert n == min(COUNTS[i][0], cfg["points_limit"])
        assert np.abs(a["src_points"][:n] - a["src_raw_points"][:n]).max() > 1e-3
        np.testing.assert_array_equal(a["metric_index"], np.arange(0, COUNTS[i][0], 5))
        if kw.get("device_prep"):
            assert not a["src_normals"].any() and not a["tgt_normals"].any()


def test_fdmatch_train_split_is_augmented(tree):
    """Train items are rotated on one side at random (unseeded, as in JAX);
    without noise the deformed source still lands on the target under the
    returned transform: as many of its points as in the entry as written."""
    from scipy.spatial import cKDTree

    cfg = Config(**_data_cfg(tree, augment_noise=0.0))
    ds = get_dataset(cfg, "train")
    assert ds.data_augmentation and not get_dataset(cfg, "val").data_augmentation

    def on_target(src, tgt, rot, trans):
        moved = src @ np.asarray(rot).T + np.asarray(trans).reshape(1, 3)
        return int((cKDTree(tgt).query(moved)[0] < 1e-4).sum())

    for i in range(len(ds)):
        entry = np.load(ds.entries[i])
        want = on_target(entry["s_pc"] + entry["s2t_flow"], entry["t_pc"], entry["rot"],
                         entry["trans"])
        item = ds[i]
        n, m = int(item["src_count"]), int(item["tgt_count"])
        assert want > 0.3 * n
        assert on_target(item["src_points"][:n], item["tgt_points"][:m], item["rot"],
                         item["trans"]) == want
        np.testing.assert_allclose(item["rot"] @ item["rot"].T, np.eye(3), atol=1e-5)


def test_get_dataset_split_mapping(tree):
    """fdmatch splits: train and val from their split files, test from
    test_info (a directory in the Lepard layout here), or from val_info when
    test_info is empty; only train augments. The 3DMatch path and an
    unknown split name are unchanged."""
    cfg = Config(**_data_cfg(tree))
    listed = read_entries(tree["split"], tree["root"])
    globbed = read_entries("split/4DLoMatch", tree["root"])
    assert listed == globbed and len(listed) == len(COUNTS)
    for mode, aug in (("train", True), ("val", False), ("test", False)):
        ds = get_dataset(cfg, mode)
        assert isinstance(ds, FDMatchDataset) and ds.data_augmentation == aug
        assert ds.entries == listed
    assert get_dataset(cfg.replace(test_info="", val_info=tree["split"]), "test").entries == listed
    with pytest.raises(FileNotFoundError, match="no <scene>"):
        read_entries("split", tree["root"])
    with pytest.raises(ValueError, match="unknown split"):
        get_dataset(cfg, "bogus")


# ---- evaluators ------------------------------------------------------------------

def _dump(seed, n=300, c=120):
    """A dump's evaluator keys: a flow pair, correspondences on its overlap
    with noise (some within the recall threshold, some not)."""
    rng = np.random.RandomState(seed)
    arr = make_flow_pair_arrays(rng, n, n, n)
    raw, deformed = arr["src_raw_points"], arr["src_points"]
    pick = rng.choice(n, c, replace=False)
    moved = deformed @ arr["rot"].T + arr["trans"].reshape(1, 3)
    tgt = moved[pick] + rng.randn(c, 3).astype(np.float32) * rng.choice([0.005, 0.1], (c, 1))
    return dict(src_raw_pcd=raw, src_pcd=deformed, src_corr_pts=deformed[pick],
                tgt_corr_pts=tgt.astype(np.float32), rot=arr["rot"], trans=arr["trans"],
                metric_index_list=np.arange(0, n, 3)[None], confidence=np.ones(c, np.float32))


def test_evaluators_match_jax(tmp_path):
    dumps = [_dump(s) for s in range(3)] + [dict(_dump(3), src_corr_pts=np.zeros((0, 3)),
                                                 tgt_corr_pts=np.zeros((0, 3)))]
    for d in dumps:
        for thr in (0.04, 0.2):
            assert compute_nrfmr(d, thr) == jax_eval.compute_nrfmr(d, thr)
            assert compute_inlier_ratio(d, thr) == jax_eval.compute_inlier_ratio(d, thr)
    assert 0.0 < compute_nrfmr(dumps[0]) < 1.0 and 0.0 < compute_inlier_ratio(dumps[0]) < 1.0
    d = dumps[1]
    got, want = (f(d["src_raw_pcd"][:50], d["src_pcd"], d["src_pcd"] - d["src_raw_pcd"], 3, 0.05)
                 for f in (blend_anchor_motion, jax_eval.blend_anchor_motion))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i, d in enumerate(dumps):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                   os.path.join(tmp_path, f"{i}.pth"))
    assert [os.path.basename(p) for p in list_dumps(str(tmp_path))] == [
        f"{i}.pth" for i in range(len(dumps))]
    assert load_dump(os.path.join(tmp_path, "0.pth")).keys() == dumps[0].keys()
    assert evaluate_fdmatch(str(tmp_path)) == jax_eval.evaluate_fdmatch(str(tmp_path))


# ---- the whole model at factor 2 against JAX ------------------------------------

@pytest.fixture(scope="module")
def model4d():
    """The port at factor 2, JAX's params of the same weights and JAX's
    with-GT eval forward, op by op."""
    tcfg, model, jcfg, params = port_and_params(0, **FD)
    assert model.coarse_proj.in_features == 512 and tcfg.channel_factor == 2
    return dict(tcfg=tcfg, model=model, jcfg=jcfg, params=params,
                jax_forward=lambda pair: JaxRoITr(jcfg).apply({"params": params}, pair,
                                                              train=False, with_gt=True))


@pytest.fixture(scope="module")
def items(tree):
    """The tree's test items from each package's dataset (equal: see
    test_fdmatch_dataset_matches_jax), JAX's with scipy normals."""
    cfg = _data_cfg(tree, **FD, mode="test")
    with pytest.MonkeyPatch.context() as mp:
        _jax_scipy_normals(mp)
        jds = jax_get_dataset(JaxConfig(**cfg), "test")
        jax_items = [jds[i] for i in range(len(jds))]
    port = get_dataset(Config(**cfg), "test")
    return [port[i] for i in range(len(port))], jax_items


@pytest.fixture(scope="module")
def eval_outputs(model4d, items):
    """Both forwards of the tree's first pair, which the Tester test reads
    too (its dump against JAX's)."""
    with torch.no_grad():
        got = model4d["model"](torch_pair(items[0][0]), train=False, with_gt=True)
    want = model4d["jax_forward"](jax_pair(items[1][0]))
    return {k: v.numpy() for k, v in got.items()}, want


def test_forward_with_gt_matches_jax(eval_outputs):
    """The adaptive buffer holds min(512, N * M) slots; its indices and
    masks exactly, the threshold keeping more than the minimum and fewer
    than all valid node pairs."""
    got, want = eval_outputs
    _assert_outputs_match(got, {k: np.asarray(v) for k, v in want.items()}, "4DMatch forward")
    n_nodes = [int(got[f"{s}_node_count"]) for s in ("src", "tgt")]
    assert got["node_corr_masks"].shape == (min(512, (BUCKET // 64) ** 2),)
    assert FD["num_est_coarse_corr"] < int(got["node_corr_masks"].sum()) < n_nodes[0] * n_nodes[1]
    assert int(got["gt_node_corr_masks"].sum()) > 0


def test_packed_forward_matches_jax(model4d):
    """Two flow pairs of the 128 bucket (host pyramids on the raw source) as
    one packed forward, against JAX's `_forward_packed` and pair by pair
    against the port's single forwards. Their 2 x 128 flat points are the
    256 bucket's rows: JAX reuses the single forward's compiled point-level
    ops."""
    tcfg, model = model4d["tcfg"], model4d["model"]
    arrays = [flow_pair_arrays(40 + i, 128, n, m) for i, (n, m) in enumerate(((120, 100),
                                                                              (90, 128)))]
    pairs = [attach_pyramids(torch_pair(a), tcfg.enc_strides, tcfg.enc_nsample) for a in arrays]
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(pack_pairs(pairs), with_gt=True).items()}
        singles = [{k: v.numpy() for k, v in model(p, with_gt=True).items()} for p in pairs]
    want = {k: np.asarray(v) for k, v in model4d["jax_forward"](jax_packed_pair(arrays)).items()}
    for i in range(len(arrays)):
        one = {k: v[i] for k, v in got.items()}
        _assert_outputs_match(one, {k: v[i] for k, v in want.items()}, f"pair {i} vs JAX")
        _assert_outputs_match(one, singles[i], f"pair {i} vs single")


def test_train_step_matches_jax(items):
    """One train forward and backward: losses, then every parameter's
    gradient. num_gt_coarse_corr >= max_gt_corr_candidates, so every
    eligible GT patch is drawn and only their order follows the noise. The
    pair has no valid GT node pair (0, 0), where the packages differ on
    purpose (ROADMAP Queue 3, `_gt_overlap_map`)."""
    tcfg, model, jcfg, params = port_and_params(0, **FD, num_gt_coarse_corr=64)
    tpair = torch_pair(items[0][0])
    out = model(tpair, train=True, with_gt=True, generator=torch.Generator().manual_seed(0))
    losses = overall_loss(tcfg, out, tpair.rot, tpair.trans)
    losses["loss"].backward()
    jpair = jax_pair(items[1][0])

    def jloss(p):
        o = JaxRoITr(jcfg).apply({"params": p}, jpair, train=True, with_gt=True,
                                 rngs={"sampling": jax.random.PRNGKey(0)})
        ls = jlosses.overall_loss(jcfg, o, jpair.rot, jpair.trans)
        return ls["loss"], (o, ls)

    loss, vjp, (jout, jls) = jax.vjp(jloss, params, has_aux=True)
    (jgrads,) = jax.jit(lambda f, ct: f(ct))(vjp, jnp.ones_like(loss))
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads),
                                transformer_architecture=ARCH["transformer_architecture"],
                                enc_blocks=ARCH["enc_blocks"])
    idx, masks = np.asarray(jout["gt_node_corr_indices"]), np.asarray(jout["gt_node_corr_masks"])
    assert masks.any() and not masks[(idx == 0).all(1)].any()
    assert float(jls["c_loss"]) > 0
    for k in ("loss", "c_loss", "f_loss", "o_loss"):
        np.testing.assert_allclose(_np(losses[k]), np.asarray(jls[k]), err_msg=k, **TOL)
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
    g = np.concatenate([got[k].ravel() for k in sorted(want)]).astype(np.float64)
    w = np.concatenate([want[k].numpy().ravel() for k in sorted(want)]).astype(np.float64)
    assert np.linalg.norm(w) > 0
    assert np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999


def _dump_rows(d):
    rows = np.concatenate([np.asarray(d["src_corr_pts"]), np.asarray(d["tgt_corr_pts"]),
                           np.asarray(d["confidence"])[:, None]], axis=1)
    return rows[:, :3], rows[:, 3:6], rows[:, 6]


def test_tester_dumps_match_jax(model4d, tree, items, eval_outputs, tmp_path, monkeypatch):
    """The port's Tester over the tree (4DLoMatch test split, host normals)
    against JAX's `trim_outputs` of its forward on JAX's dataset items, dump
    by dump: the same keys and dtypes, `src_pcd` the deformed source and
    `src_raw_pcd` the raw one, metric_index_list; then each package's
    `evaluate_fdmatch` of its own dumps."""
    monkeypatch.chdir(tmp_path)
    cfg = _data_cfg(tree, **FD, mode="test", num_workers=0)
    cfg["benchmark"] = "4DLoMatch"
    tcfg, jcfg = Config(**cfg), JaxConfig(**cfg)
    PortTester(tcfg, state_dict=model4d["model"].state_dict(), device="cpu").test()
    port_dir = os.path.join("snapshot", tcfg.exp_dir, "4DLoMatch")
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    for i, item in enumerate(items[1]):
        jpair = jax_pair(item)
        out = eval_outputs[1] if i == 0 else model4d["jax_forward"](jpair)
        want = jax_tester.trim_outputs(jax_tester.fetch_outputs(out), jpair,
                                       metric_index=item["metric_index"])
        jax_tester.dump_pair(str(jax_dir / str(i)), want)
        got = load_dump(os.path.join(port_dir, f"{i}.pth"))
        assert set(got) == set(want)
        for k, w in want.items():
            g, w = np.asarray(got[k]), np.asarray(w)
            assert g.dtype == w.dtype, k
            if k not in ("src_corr_pts", "tgt_corr_pts", "confidence"):
                assert g.shape == w.shape, k
                np.testing.assert_allclose(g, w, err_msg=f"pair {i}: {k}", **TOL)
        n = COUNTS[i][0]
        entry = np.load(read_entries(tcfg.test_info, tcfg.root)[i])
        np.testing.assert_allclose(got["src_pcd"] - got["src_raw_pcd"], entry["s2t_flow"][:n],
                                   atol=1e-6)
        np.testing.assert_array_equal(got["metric_index_list"], np.arange(0, n, 5))
        same_correspondences(_dump_rows(got), _dump_rows(want), f"pair {i}")
    got, want = evaluate_fdmatch(port_dir), jax_eval.evaluate_fdmatch(str(jax_dir))
    assert set(got) == {"NFMR", "IR"}
    for k in got:
        assert abs(got[k] - want[k]) <= 0.02, (k, got[k], want[k])


def test_tester_packed_host_pyramid_and_device_prep(model4d, tree, tmp_path, monkeypatch):
    """The port's 4DMatch Tester with host pyramids (built on the raw
    source), with device prep (normals of the raw source on the device) and
    with both packed in batches of two: each packed dump equals the
    single-pair Tester's under the same prep (rtol 1e-4 / atol 1e-5, the
    correspondences as sets), c2f dumps are full dumps' subset, and every
    dump carries the deformed and the raw source."""
    monkeypatch.chdir(tmp_path)
    state = model4d["model"].state_dict()
    base = Config(**_data_cfg(tree, **FD, mode="test", num_workers=0))
    for prep in (dict(host_pyramid=True), dict(device_prep=True, dump_mode="c2f")):
        dumps = {}
        for name, extra in (("single", {}), ("packed", dict(packed_batch=True, batch_size=2))):
            cfg = base.replace(exp_dir=f"{name}_{len(prep)}", **prep, **extra)
            tester = PortTester(cfg, state_dict=state, device="cpu")
            tester.test()
            dumps[name] = [load_dump(p) for p in list_dumps(tester.snapshot_dir)]
        assert len(dumps["single"]) == len(dumps["packed"]) == len(COUNTS)
        for i, (single, packed) in enumerate(zip(dumps["single"], dumps["packed"])):
            tag = f"{prep} pair {i}"
            assert set(single) == set(packed), tag
            for k, w in single.items():
                if k not in ("src_corr_pts", "tgt_corr_pts", "confidence"):
                    np.testing.assert_allclose(packed[k], w, err_msg=f"{tag}: {k}", **TOL)
            same_correspondences(_dump_rows(packed), _dump_rows(single), tag)
            n = COUNTS[i][0]
            assert np.abs(single["src_pcd"] - single["src_raw_pcd"]).max() > 1e-3
            assert single["src_pcd"].shape == (n, 3) and "metric_index_list" in single


def test_matcher_at_4dmatch(model4d):
    """Matcher(benchmark 4DMatch, host pyramids) on raw clouds: `match`
    equals the forward of the prepared pair (the source is its own raw
    geometry, as in JAX's serving), and `match_batch` packed and mapped
    equals `match`."""
    cfg = model4d["tcfg"].replace(buckets=(BUCKET,), host_pyramid=True)
    matcher = Matcher(cfg, model4d["model"].state_dict(), device="cpu")
    clouds = []
    for i, (n, m) in enumerate(COUNTS):
        arr = flow_pair_arrays(60 + i, BUCKET, n, m)
        clouds.append((arr["src_points"][:n], arr["tgt_points"][:m]))
    single = [matcher.match(s, t) for s, t in clouds]
    pair, _ = matcher._prepare(*clouds[0], None, None)
    assert torch.equal(pair.src_points, pair.src_raw_points)
    with torch.no_grad():
        out = model4d["model"](pair)
    rows = lambda d: (d["src_corr_pts"], d["tgt_corr_pts"], d["confidence"])  # noqa: E731
    same_correspondences(rows(single[0]), _kept(out), "match vs forward")
    for mode in ("packed", "map"):
        for got, want in zip(matcher.match_batch(clouds, batch_size=2, mode=mode), single):
            same_correspondences(rows(got), rows(want), mode)


def test_trainer_on_the_fdmatch_config(tree, tmp_path, monkeypatch):
    """`Trainer` from configs/train/fdmatch.yaml through load_config (one
    override for the port, knn_method "exact", plus the cuts to a tiny
    model and the tree): iter_size 4 at batch 1 over 4 pairs is one update
    an epoch, after which the rate has fallen once, as JAX's staircase
    (transition 4 // 4 = 1 update) has; validation runs."""
    monkeypatch.chdir(tmp_path)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "train", "fdmatch.yaml")
    cfg = load_config(path, knn_method="exact", root=tree["root"], train_info=tree["split"],
                      val_info=tree["split"], buckets=(BUCKET,), points_limit=BUCKET,
                      normal_knn=9, num_est_coarse_corr=8, num_gt_coarse_corr=8,
                      point_per_patch=8, sinkhorn_iters=5, max_gt_corr_candidates=16,
                      max_epoch=1, training_max_iter=4, val_max_iter=1, verbose=False,
                      scheduler_gamma=0.5, num_workers=0, **ARCH)
    assert (cfg.iter_size, cfg.batch_size, cfg.channel_factor, cfg.dataset) == (
        4, 1, 2, "fdmatch")
    train_set = [get_dataset(cfg, "train")[i % len(COUNTS)] for i in range(4)]
    trainer = Trainer(cfg, train_set, device="cpu")
    assert isinstance(trainer.val_dataset, FDMatchDataset)
    w0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    metrics = trainer.train_epoch(0)  # train() adds the checkpoints, as at 3DMatch
    assert trainer.step == 4 and trainer.optimizer.scheduler.last_epoch == 1
    assert trainer.optimizer.inner.param_groups[0]["lr"] == pytest.approx(cfg.lr * 0.5)
    assert np.isfinite(metrics["loss"]) and np.isfinite(trainer.eval_epoch(0)["loss"])
    assert any(not torch.equal(v, w0[k]) for k, v in trainer.model.state_dict().items())


def test_roitr_takes_the_non_rigid_benchmarks():
    model = RoITr(Config(benchmark="4DLoMatch"), device="cpu")
    assert model.coarse_proj.in_features == model.fine_proj.out_features == 512
