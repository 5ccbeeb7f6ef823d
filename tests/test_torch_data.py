"""The port's data pipeline (roitr_torch/data/: preprocess_pair, the 3DMatch
dataset, get_dataset) against the JAX package's on the CPU.

Both packages get the same clouds and seeded RandomStates. The JAX package
estimates host normals with its native KD-tree when that is built, the
port with scipy, so `roitr_tpu.native.available` is turned off here: then
points, counts, GT transforms and every other array are equal, and normals
within 1e-6. The dataset tests write a tree in the reference's layout
(`.pth` clouds and an info pickle, as tests/test_data.py's
`tdmatch_fixture`) in tmp_path.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.preprocess import preprocess_pair
from roitr_torch.data.synthetic import make_pair_arrays
from roitr_torch.data.tdmatch import _load_cloud
from roitr_tpu.config import Config as JaxConfig
from roitr_tpu.data import get_dataset as jax_get_dataset
from roitr_tpu.data.preprocess import preprocess_pair as jax_preprocess_pair

SMALL = dict(buckets=(256, 512), points_limit=400, normal_knn=9)


@pytest.fixture(autouse=True)
def scipy_normals_in_jax(monkeypatch):
    import roitr_tpu.native

    monkeypatch.setattr(roitr_tpu.native, "available", lambda: False)


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("_normals"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _clouds(seed, n=450, m=380):
    arr = make_pair_arrays(np.random.RandomState(seed), max(n, m), n, m)
    return arr["src_points"][:n], arr["tgt_points"][:m], arr["rot"], arr["trans"]


@pytest.mark.parametrize("mode", ["plain", "augmented", "rotated", "device_prep", "raw_source"])
def test_preprocess_pair_matches_jax(mode):
    src, tgt, rot, trans = _clouds(3)
    kw = dict(buckets=SMALL["buckets"], points_limit=SMALL["points_limit"], normal_knn=9)
    if mode == "augmented":
        kw["augment"] = True
    elif mode == "rotated":
        kw["rotated_index"] = 5
    elif mode == "device_prep":
        kw["device_prep"] = True
    elif mode == "raw_source":
        kw.update(src_raw_pcd=src[:300] * 1.5, metric_index=np.arange(7)[None])
        src = src[:300]
    got = preprocess_pair(np.random.RandomState(11), src, tgt, rot, trans.ravel(), **kw)
    want = jax_preprocess_pair(np.random.RandomState(11), src, tgt, rot, trans.ravel(), **kw)
    assert_items_equal(got, want)
    if mode == "device_prep":
        assert not got["src_normals"].any() and not got["tgt_normals"].any()
    if mode in ("augmented", "rotated"):
        assert not np.allclose(got["rot"], rot)


def test_preprocess_pair_refuses_host_pyramids():
    """`build_pyramid` builds both clouds' host pyramids as JAX does: the
    source side on the raw source geometry, none under device prep. Here
    the JAX package takes its scipy path (native turned off above), the
    port its native library: indices equal, upsampling weights within 1e-6
    (float32 against float64 distances); tests/test_torch_pyramid.py holds
    the two native paths bit for bit."""
    from roitr_torch.data.pyramid import CloudPyramid

    src, tgt, rot, trans = _clouds(4)
    kw = dict(buckets=(512,), normal_knn=9, build_pyramid=True,
              src_raw_pcd=src * 1.5)
    got = preprocess_pair(np.random.RandomState(0), src, tgt, rot, trans, **kw)
    want = jax_preprocess_pair(np.random.RandomState(0), src, tgt, rot, trans, **kw)
    pyramids = ("src_pyramid", "tgt_pyramid")
    assert_items_equal({k: v for k, v in got.items() if k not in pyramids},
                       {k: v for k, v in want.items() if k not in pyramids})
    for side in pyramids:
        for name in CloudPyramid._fields:
            g, w = getattr(got[side], name), getattr(want[side], name)
            assert g.dtype == w.dtype and g.shape == w.shape, (side, name)
            if name.startswith("up_w"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{side} {name}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{side} {name}")
    dev = preprocess_pair(np.random.RandomState(0), src, tgt, rot, trans, device_prep=True,
                          **kw)
    assert not set(pyramids) & set(dev)


@pytest.fixture
def tdmatch_tree(tmp_path):
    """Three pairs in the reference layout; pair 1's source is the fragment
    the reference skips (7-scenes-fire/cloud_bin_19.pth)."""
    rng = np.random.RandomState(0)
    root = tmp_path / "indoor"
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    for i, scene in enumerate(("scene1", "7-scenes-fire", "scene1")):
        (root / "test" / scene).mkdir(parents=True, exist_ok=True)
        arr = make_pair_arrays(rng, 512, 300 + 60 * i, 280)
        src_name = "cloud_bin_19.pth" if scene == "7-scenes-fire" else f"cloud_bin_{2 * i}.pth"
        torch.save(torch.from_numpy(arr["src_points"][:300 + 60 * i]),
                   root / "test" / scene / src_name)
        torch.save(torch.from_numpy(arr["tgt_points"][:280]),
                   root / "test" / scene / f"cloud_bin_{2 * i + 1}.pth")
        infos["src"].append(f"test/{scene}/{src_name}")
        infos["tgt"].append(f"test/{scene}/cloud_bin_{2 * i + 1}.pth")
        infos["rot"].append(arr["rot"])
        infos["trans"].append(arr["trans"])
        infos["overlap"].append(0.5)
    info_path = tmp_path / "info.pkl"
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return dict(root=str(root), train_info=str(info_path), val_info=str(info_path),
                test_info=str(info_path))


@pytest.mark.parametrize("mode,rotated", [("val", False), ("test", False), ("test", True)])
def test_tdmatch_dataset_matches_jax(tdmatch_tree, mode, rotated):
    """Val and test pairs are seeded by index, so both packages read the
    same items; `rotated` turns each pair by its index's rotation; the
    skipped fragment's index reads the next pair."""
    kw = {**SMALL, **tdmatch_tree, "rotated": rotated}
    got_ds, want_ds = get_dataset(Config(**kw), mode), jax_get_dataset(JaxConfig(**kw), mode)
    assert len(got_ds) == len(want_ds) == 3
    items = [got_ds[i] for i in range(3)]
    for i, item in enumerate(items):
        assert_items_equal(item, want_ds[i])
    assert_items_equal(items[1], items[2])  # the skipped fragment's index read pair 2
    assert int(items[2]["src_count"]) == SMALL["points_limit"]  # 420 points capped
    if rotated:
        plain = get_dataset(Config(**{**kw, "rotated": False}), mode)[0]
        assert not np.allclose(plain["rot"], items[0]["rot"])


def test_tdmatch_device_prep_ships_zero_normals(tdmatch_tree):
    kw = {**SMALL, **tdmatch_tree, "device_prep": True}
    got, want = get_dataset(Config(**kw), "test")[0], jax_get_dataset(JaxConfig(**kw), "test")[0]
    assert_items_equal(got, want)
    assert not got["src_normals"].any()


def test_train_split_is_augmented(tdmatch_tree):
    """Train pairs draw fresh randomness: same shapes as JAX's, and a
    rotation other than the GT's."""
    kw = {**SMALL, **tdmatch_tree}
    got, want = get_dataset(Config(**kw), "train"), jax_get_dataset(JaxConfig(**kw), "train")
    assert len(got) == len(want)
    a, b = got[0], want[0]
    assert {k: np.shape(v) for k, v in a.items()} == {k: np.shape(v) for k, v in b.items()}
    info = pickle.load(open(tdmatch_tree["train_info"], "rb"))
    assert not np.allclose(a["rot"], info["rot"][0])


def test_default_test_split_is_the_vendored_benchmark():
    """With no test_info the split is configs/tdmatch/<benchmark>.pkl, found
    from any working directory; only the pickle is read here."""
    for bench in ("3DMatch", "3DLoMatch"):
        got = get_dataset(Config(benchmark=bench), "test")
        want = jax_get_dataset(JaxConfig(benchmark=bench), "test")
        assert len(got) == len(want) > 1000
        assert got.infos["src"] == want.infos["src"]


def test_get_dataset_refuses_what_is_not_ported(tmp_path):
    """The 4DMatch dataset is ported: a split of one `.npz` entry builds an
    FDMatchDataset (tests/test_torch_fdmatch.py holds it against JAX's); a
    dataset neither package has is still refused."""
    from roitr_torch.data.fdmatch import FDMatchDataset
    from roitr_torch.data.synthetic import make_flow_pair_arrays

    arr = make_flow_pair_arrays(np.random.RandomState(0), 128, 120, 100)
    os.makedirs(tmp_path / "split" / "4DMatch" / "scene0")
    np.savez(tmp_path / "split" / "4DMatch" / "scene0" / "pair0.npz",
             s_pc=arr["src_raw_points"][:120], t_pc=arr["tgt_points"][:100],
             s2t_flow=arr["flow"][:120], rot=arr["rot"], trans=arr["trans"])
    cfg = Config(dataset="fdmatch", benchmark="4DMatch", root=str(tmp_path), buckets=(128,),
                 normal_knn=9, test_info="split/4DMatch")
    ds = get_dataset(cfg, "test")
    assert isinstance(ds, FDMatchDataset) and len(ds) == 1
    assert int(ds[0]["src_count"]) == 120 and "metric_index" not in ds[0]
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset(Config(dataset="kitti"), "test")


@pytest.mark.parametrize("fmt", ["pth", "npy", "npz"])
def test_load_cloud_formats(tmp_path, fmt):
    pts = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    path = str(tmp_path / f"c.{fmt}")
    if fmt == "pth":
        torch.save(torch.from_numpy(pts), path)
    elif fmt == "npy":
        np.save(path, pts)
    else:
        np.savez(path, points=pts)
    got = _load_cloud(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pts)


def test_trainer_builds_its_datasets_from_the_config(tdmatch_tree, tmp_path, monkeypatch):
    """Trainer(cfg) with no datasets reads the config's splits, as the JAX
    Trainer does (roitr_tpu/train/trainer.py:55-56); its validation pass
    runs on them."""
    from roitr_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    kw = dict(SMALL, **tdmatch_tree, num_est_coarse_corr=8, num_gt_coarse_corr=8,
              point_per_patch=8, sinkhorn_iters=5, max_gt_corr_candidates=16, val_max_iter=1,
              verbose=False, num_workers=0)
    trainer = Trainer(Config(**kw), device="cpu")
    want_val = jax_get_dataset(JaxConfig(**kw), "val")
    assert len(trainer.train_dataset) == len(trainer.val_dataset) == len(want_val)
    assert_items_equal(trainer.val_dataset[0], want_val[0])
    metrics = trainer.eval()
    assert np.isfinite(metrics["loss"])
