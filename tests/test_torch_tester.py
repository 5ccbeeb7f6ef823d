"""The port's Tester path (roitr_torch/eval/tester.py) against the JAX
package on the CPU: a test split in the reference layout (`.pth` clouds
and an info pickle in a temporary directory), the same weights in both
packages.

- The port's forward after `device_prep_pair` against JAX's forward after
  `device_prep_pair(..., pyramid=True)`, with the GT analysis, key by key:
  fp32 outputs within rtol 1e-4 / atol 1e-5, indices exactly.
- The port's dumps, full and c2f, against JAX's `trim_outputs(
  fetch_outputs(...))` (and `compact_corr` for c2f) of that forward: the
  same keys and dtypes; arrays within rtol 1e-4 / atol 1e-5; the
  correspondence rows compared as a set, as `_fine_set` in
  tests/test_torch_pipeline.py does.
- JAX's `benchmark_registration` reads the port's dumps unchanged.
- Host prep against device prep: geometry keys equal, node descriptors at
  min cosine > 0.99 (the JAX package's own check,
  tests/test_trainer.py:386).

Both packages store the geometric embedding in fp32 and keep every fine
correspondence (`fine_matching_confidence_threshold=0.0`: random weights
give a uniform OT plan below the default 0.05), so the arrays are not
empty. The JAX forward runs un-jitted at the 512 bucket: a jitted program
rounds differently (tests/test_torch_pipeline.py).
"""

import os
import pickle
import threading

import numpy as np
import jax
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.synthetic import SyntheticPairs, make_pair_arrays
from roitr_torch.eval import Tester as PortTester
from roitr_torch.eval import get_trainer
from roitr_torch.eval.tester import C2F_KEYS, C2F_PLACEHOLDERS, DUMP_KEYS, compact_corr
from roitr_torch.eval.tester import fetch_outputs, trim_outputs
from roitr_torch.ops.pyramid import device_prep_pair
from roitr_tpu.data import get_dataset as jax_get_dataset
from roitr_tpu.eval import tester as jax_tester
from roitr_tpu.models.roitr import RoITr as JaxRoITr
from roitr_tpu.ops.pyramid import device_prep_pair as jax_device_prep_pair

from torch_parity import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    TINY,
    jax_pair,
    one_thread,
    one_torch_thread,
    port_and_params,
    same_correspondences,
    torch_pair,
)

TOL = dict(rtol=1e-4, atol=1e-5)
COUNTS = ((480, 400), (450, 470))


def _write_tree(base):
    """Two pairs under test/<scene>/cloud_bin_<i>.pth and their info pickle."""
    rng = np.random.RandomState(21)
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    os.makedirs(os.path.join(base, "indoor", "test", "scene0"))
    for i, (n, m) in enumerate(COUNTS):
        arr = make_pair_arrays(rng, 512, n, m)
        for j, cloud in ((2 * i, arr["src_points"][:n]), (2 * i + 1, arr["tgt_points"][:m])):
            torch.save(torch.from_numpy(cloud.copy()),
                       os.path.join(base, "indoor", "test", "scene0", f"cloud_bin_{j}.pth"))
        infos["src"].append(f"test/scene0/cloud_bin_{2 * i}.pth")
        infos["tgt"].append(f"test/scene0/cloud_bin_{2 * i + 1}.pth")
        infos["rot"].append(arr["rot"])
        infos["trans"].append(arr["trans"])
        infos["overlap"].append(0.5)
    with open(os.path.join(base, "test.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return dict(root=os.path.join(base, "indoor"), test_info=os.path.join(base, "test.pkl"))


def _load(exp, i):
    return torch.load(os.path.join("snapshot", exp, "3DMatch", f"{i}.pth"), weights_only=False)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Port Testers (host prep full; device prep full and c2f) over the tree,
    and the JAX forward of pair 0 after device prep."""
    base = str(tmp_path_factory.mktemp("tester"))
    tree = _write_tree(base)
    kw = dict(tree, mode="test", geo_embedding_storage="fp32", num_workers=0,
              fine_matching_confidence_threshold=0.0)
    tcfg, model, jcfg, params = port_and_params(0, **kw)
    state_dict = model.state_dict()
    ckpt = os.path.join(base, "weights.pth")
    torch.save({"model": state_dict}, ckpt)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(base)
        get_trainer(tcfg.replace(exp_dir="host", pretrain=ckpt), device="cpu").test()
        get_trainer(tcfg.replace(exp_dir="dev", pretrain=ckpt, device_prep=True),
                    device="cpu").test()
        PortTester(tcfg.replace(exp_dir="dev_c2f", device_prep=True, dump_mode="c2f"),
               state_dict=state_dict, device="cpu").test()
        dumps = {exp: [_load(exp, i) for i in range(len(COUNTS))]
                 for exp in ("host", "dev", "dev_c2f")}

    dcfg = tcfg.replace(device_prep=True)
    item = get_dataset(dcfg, "test")[0]
    with torch.no_grad():
        port_out = model(device_prep_pair(torch_pair(item), dcfg), with_gt=True)
    jitem = jax_get_dataset(jcfg.replace(device_prep=True), "test")[0]
    jpair = jax_device_prep_pair(jax_pair(jitem), jcfg, pyramid=True)
    jax_out = JaxRoITr(jcfg).apply({"params": params}, jpair, train=False, with_gt=True)
    return dict(dumps=dumps, port_out=port_out, jax_out=jax_out, jpair=jpair, item=item,
                tcfg=tcfg, state_dict=state_dict, base=base)


# rows past a cloud's valid count: JAX's prepared pyramid zeroes its pad
# rows (roitr_tpu/ops/pyramid.py), the port's in-forward build, like JAX's
# own in-forward build, does not, so these rows differ in both packages'
# forwards with and without a prepared pyramid; every later stage masks them
# and the dumps trim them
VALID_PREFIX = {"src_nodes": "src_node_count", "src_node_feats": "src_node_count",
                "tgt_nodes": "tgt_node_count", "tgt_node_feats": "tgt_node_count",
                "src_point_feats": "src_count", "tgt_point_feats": "tgt_count"}


def test_forward_after_device_prep_matches_jax(run):
    """Every output whole, but the backbone's per-point and per-node rows
    on their valid prefix, and the fine correspondences as a set (compared
    in the dumps below)."""
    got = {k: v.numpy() for k, v in run["port_out"].items()}
    want = {k: np.asarray(v) for k, v in run["jax_out"].items()}
    assert set(got) == set(want)
    fine = ("tgt_corr_points", "src_corr_points", "corr_scores", "corr_masks")
    for k in sorted(set(want) - set(fine)):
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if k in VALID_PREFIX:
            n = int(want[VALID_PREFIX[k]])
            assert 0 < n < len(w), k
            g, w = g[:n], w[:n]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=k)
    assert int(got["corr_masks"].sum()) == int(want["corr_masks"].sum()) > 0


def _corr_rows(d):
    """The dump's correspondences as rows [src xyz, tgt xyz, confidence],
    sorted: the order of a row's top-k slots follows near-equal logits that
    two packages may round either way."""
    rows = np.concatenate([np.asarray(d["src_corr_pts"]), np.asarray(d["tgt_corr_pts"]),
                           np.asarray(d["confidence"])[:, None]], axis=1)
    return rows[np.lexsort(rows[:, :6].T[::-1])]


def _assert_dump_matches(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k not in ("src_corr_pts", "tgt_corr_pts", "confidence"):
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
    g, w = _corr_rows(got), _corr_rows(want)
    assert g.shape == w.shape and len(g) > 0
    np.testing.assert_array_equal(g[:, :6], w[:, :6])
    np.testing.assert_allclose(g[:, 6], w[:, 6], **TOL)


def test_full_dump_matches_jax(run):
    want = jax_tester.trim_outputs(jax_tester.fetch_outputs(run["jax_out"]), run["jpair"])
    _assert_dump_matches(run["dumps"]["dev"][0], want)


def test_c2f_dump_matches_jax(run):
    cap = run["tcfg"].dump_corr_cap
    out = jax_tester.compact_corr(run["jax_out"], cap)
    want = jax_tester.trim_outputs(jax_tester.fetch_outputs(out, jax_tester.C2F_KEYS),
                                   run["jpair"])
    _assert_dump_matches(run["dumps"]["dev_c2f"][0], want)


def test_dump_keys_are_the_jax_tester_s():
    assert (DUMP_KEYS, C2F_KEYS, C2F_PLACEHOLDERS) == (
        jax_tester.DUMP_KEYS, jax_tester.C2F_KEYS, jax_tester.C2F_PLACEHOLDERS)


def test_dumps_ragged_and_c2f_equals_full(run):
    """Ragged shapes equal the valid counts; under the cap the c2f dump's
    correspondence arrays equal the full dump's, row for row; c2f's
    placeholders are empty."""
    for i, (n, m) in enumerate(COUNTS):
        full, c2f = run["dumps"]["dev"][i], run["dumps"]["dev_c2f"][i]
        assert full["src_pcd"].shape == full["src_raw_pcd"].shape == (n, 3)
        assert full["tgt_pcd"].shape == (m, 3)
        assert full["src_point_desc"].shape == (n, 256)
        assert full["src_node_desc"].shape[0] == full["src_nodes"].shape[0]
        assert full["gt_src_node_occ"].shape[0] == full["src_nodes"].shape[0]
        for k in set(full) - set(C2F_PLACEHOLDERS):
            assert torch.equal(full[k], c2f[k]), (i, k)
        for k in C2F_PLACEHOLDERS:
            assert c2f[k].numel() == 0 and full[k].numel() > 0


def test_host_prep_against_device_prep(run):
    for a, b in zip(run["dumps"]["host"], run["dumps"]["dev"]):
        for k in ("src_pcd", "tgt_pcd", "src_raw_pcd", "src_nodes", "tgt_nodes", "rot", "trans"):
            assert torch.equal(a[k], b[k]), k
        for k in ("src_node_desc", "tgt_node_desc"):
            cos = torch.nn.functional.cosine_similarity(a[k].double(), b[k].double(), dim=-1)
            assert float(cos.min()) > 0.99, (k, float(cos.min()))


def test_registration_evaluator_reads_the_dumps(run, tmp_path):
    """JAX's benchmark_registration on the port's dumps, with a TinyMatch
    gt folder (tests/test_eval.py:166) whose pairs carry the dumps' GT."""
    from roitr_tpu.eval.registration import benchmark_registration

    dump_dir = os.path.join(run["base"], "snapshot", "dev", "3DMatch")
    scene = tmp_path / "gt" / "TinyMatch" / "scene0"
    scene.mkdir(parents=True)
    log, info = [], []
    for p, d in enumerate(run["dumps"]["dev"]):
        t = np.eye(4)
        t[:3, :3], t[:3, 3] = d["rot"].numpy(), d["trans"].numpy().ravel()
        log += [f"{p}\t{p + 2}\t8"] + ["\t".join(f"{v:.12f}" for v in row) for row in t]
        info += [f"{p}\t{p + 2}\t8"] + ["\t".join(f"{v:.6f}" for v in row)
                                         for row in np.eye(6) * 100]
    (scene / "gt.log").write_text("\n".join(log) + "\n")
    (scene / "gt.info").write_text("\n".join(info) + "\n")
    res = benchmark_registration(dump_dir, str(tmp_path / "exp"), "TinyMatch", n_points=64,
                                 gt_folder=str(tmp_path / "gt" / "TinyMatch"),
                                 ransac_iterations=500, seed=0)
    assert 0.0 <= res["inlier_ratio"] <= 1.0 and 0.0 <= res["feature_match_recall"] <= 1.0
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float))
    assert os.path.exists(tmp_path / "exp" / "TinyMatch" / "64" / "result")


def test_matcher_device_prep_matches_jax(run, monkeypatch):
    """Matcher(prep="device") on raw clouds without normals: the port
    estimates them on the device, the JAX Matcher in its program (with its
    pyramid). Nodes exactly, descriptors within tolerance; the kept
    correspondences as a set, at most 2% of their union apart (near-ties
    of random weights, as in tests/test_torch_pipeline.py), their sorted
    confidences within tolerance."""
    from roitr_torch.serving import Matcher
    from roitr_tpu.serving import Matcher as JaxMatcher

    cfg = run["tcfg"].replace(mode="train")
    item = get_dataset(cfg, "test")[1]
    src = item["src_points"][:int(item["src_count"])]
    tgt = item["tgt_points"][:int(item["tgt_count"])]
    got = Matcher(cfg, run["state_dict"], device="cpu", descriptors=True,
                  prep="device").match(src, tgt)
    _, _, jcfg, params = port_and_params(0, **{k: getattr(cfg, k) for k in (
        "root", "test_info", "geo_embedding_storage", "fine_matching_confidence_threshold")})
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    want = JaxMatcher(jcfg, params, descriptors=True, prep="device").match(src, tgt)
    assert set(got) == set(want)
    for key in ("src_nodes", "tgt_nodes"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("src_node_desc", "tgt_node_desc", "src_point_desc", "tgt_point_desc"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    np.testing.assert_allclose(np.sort(got["confidence"]), np.sort(want["confidence"]), **TOL)
    g, w = (set(map(tuple, np.concatenate([o["src_corr_pts"], o["tgt_corr_pts"]], 1).tolist()))
            for o in (got, want))
    assert len(g) > 0 and len(g ^ w) <= 0.02 * len(g | w)


def test_matcher_refuses_an_unknown_prep():
    from roitr_torch.serving import Matcher

    with pytest.raises(ValueError, match="prep"):
        Matcher(Config(**SMALL), {}, device="cpu", prep="gpu")


# ---- the two faults of the JAX Tester (ADVICE.md) and the refusals, on
# small synthetic pairs

SMALL = dict(TINY, point_per_patch=8, num_est_coarse_corr=8, sinkhorn_iters=5,
             max_gt_corr_candidates=16, buckets=(128,), mode="test", num_workers=0,
             fine_matching_confidence_threshold=0.0)


def test_c2f_output_is_never_masked_by_corr_masks():
    """compact_corr drops the mask of the original order, and trim_outputs
    takes the c2f branch whenever corr_count is there, even beside the
    full-mode keys."""
    g = torch.Generator().manual_seed(0)
    masks = torch.tensor([False, True, False, True, True, False])
    out = {"corr_masks": masks, "src_corr_points": torch.rand(6, 3, generator=g),
           "tgt_corr_points": torch.rand(6, 3, generator=g),
           "corr_scores": torch.rand(6, generator=g),
           "src_count": torch.tensor(4), "tgt_count": torch.tensor(4),
           "src_node_count": torch.tensor(2), "tgt_node_count": torch.tensor(2),
           "src_points": torch.rand(4, 3), "tgt_points": torch.rand(4, 3),
           "src_nodes": torch.rand(2, 3), "tgt_nodes": torch.rand(2, 3),
           "src_node_feats": torch.rand(2, 8), "tgt_node_feats": torch.rand(2, 8),
           "src_point_feats": torch.rand(4, 8), "tgt_point_feats": torch.rand(4, 8),
           "gt_src_node_occ": torch.rand(2), "gt_tgt_node_occ": torch.rand(2)}
    res = compact_corr(out, cap=16)
    assert "corr_masks" not in res
    with pytest.raises(KeyError):
        fetch_outputs(res, DUMP_KEYS)
    pair = torch_pair(SyntheticPairs(1, 128, normal_knn=9)[0])
    data = trim_outputs({k: v.numpy() for k, v in res.items()}, pair)
    np.testing.assert_array_equal(data["src_corr_pts"], out["src_corr_points"][masks].numpy())
    np.testing.assert_array_equal(data["confidence"], out["corr_scores"][masks].numpy())
    assert all(data[k].size == 0 for k in C2F_PLACEHOLDERS)
    with pytest.warns(UserWarning, match="truncated"):
        data = trim_outputs(fetch_outputs(compact_corr(out, cap=2), C2F_KEYS), pair)
    np.testing.assert_array_equal(data["tgt_corr_pts"], out["tgt_corr_points"][masks][:2].numpy())


def _dump_threads():
    return [t for t in threading.enumerate() if t.name == "roitr-tester-dump"]


@pytest.mark.parametrize("where", ["forward", "dump"])
def test_a_failure_leaves_no_thread_and_no_queued_dump(tmp_path, monkeypatch, where):
    """A forward that raises on pair 2 of 4: pairs 0 and 1, queued before
    it, are dumped, the worker ends, and the error reaches the caller. A
    dump that raises: its error reaches the caller, and the worker ends."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**SMALL)
    tester = PortTester(cfg, dataset=SyntheticPairs(4, 128, normal_knn=9), device="cpu",
                    state_dict=port_and_params(0, **SMALL)[1].state_dict())
    if where == "forward":
        calls, forward = [], tester._forward

        def failing(pair):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("forward failed")
            return forward(pair)

        monkeypatch.setattr(tester, "_forward", failing)
    else:
        def failing(path_base, data):
            raise OSError("disk full")

        monkeypatch.setattr("roitr_torch.eval.tester.dump_pair", failing)
    with pytest.raises(RuntimeError if where == "forward" else OSError):
        tester.test()
    assert not _dump_threads()
    written = sorted(os.listdir(tester.snapshot_dir))
    assert written == (["0.pth", "1.pth"] if where == "forward" else [])


@pytest.mark.parametrize("option", [dict(dp_size=2), dict(packed_batch=True)])
def test_tester_refuses_later_slices(tmp_path, monkeypatch, option):
    """dp_size > 1 is refused (DDP is a later slice). packed_batch is
    ported: over three pairs in packs of two (a full pack and a ragged tail
    of one), with host pyramids and with device prep
    in full and c2f dumps, the dumps equal the single-pair Tester's file by
    file: the same keys, dtypes and shapes, arrays within rtol 1e-4 / atol
    1e-5 (the packed forward's larger products round differently), the
    correspondence rows as sets with near-ties of random weights allowed
    (tests/torch_parity.py `same_correspondences`). Without host
    pyramids or device prep a packed Tester is refused, as JAX's is."""
    monkeypatch.chdir(tmp_path)
    if "dp_size" in option:
        with pytest.raises(NotImplementedError, match="later slice"):
            PortTester(Config(**SMALL, **option), dataset=SyntheticPairs(1, 128), device="cpu",
                       state_dict={})
        return
    with pytest.raises(ValueError, match="host_pyramid or device_prep"):
        PortTester(Config(**SMALL, batch_size=2, **option), dataset=SyntheticPairs(1, 128),
                   device="cpu", state_dict={})
    with one_thread():
        _packed_tester_dumps_equal_single(option)


def _packed_tester_dumps_equal_single(option):
    state_dict = port_and_params(0, **SMALL)[1].state_dict()
    for kw in (dict(host_pyramid=True), dict(device_prep=True),
               dict(device_prep=True, dump_mode="c2f")):
        base = Config(**SMALL, **kw)
        dumps = {}
        for name, cfg in (("single", base.replace(exp_dir="single")),
                          ("packed", base.replace(exp_dir="packed", batch_size=2, **option))):
            ds = SyntheticPairs(3, 128, counts=(90, 128), normal_knn=9)
            if cfg.host_pyramid:
                from roitr_torch.data.pyramid import build_cloud_pyramid

                items = [ds[i] for i in range(3)]
                for item in items:
                    item["src_pyramid"] = build_cloud_pyramid(item["src_raw_points"],
                                                              item["src_count"])
                    item["tgt_pyramid"] = build_cloud_pyramid(item["tgt_points"],
                                                              item["tgt_count"])
                ds = items
            tester = PortTester(cfg, dataset=ds, device="cpu", state_dict=state_dict)
            shapes = []
            tester.model.register_forward_pre_hook(
                lambda _, args: shapes.append(tuple(args[0].src_count.shape)))
            tester.test()
            # the ragged tail runs as a pack of one, not padded
            assert shapes == ([(2,), (1,)] if name == "packed" else [()] * 3), (name, shapes)
            dumps[name] = [torch.load(os.path.join(tester.snapshot_dir, f"{i}.pth"),
                                      weights_only=False) for i in range(3)]
            assert sorted(os.listdir(tester.snapshot_dir)) == ["0.pth", "1.pth", "2.pth"]
        for i, (single, packed) in enumerate(zip(dumps["single"], dumps["packed"])):
            tag = f"{kw} pair {i}"
            assert set(single) == set(packed), tag
            corr = ("src_corr_pts", "tgt_corr_pts", "confidence")
            for key, want in single.items():
                got = packed[key]
                assert got.dtype == want.dtype and got.shape[1:] == want.shape[1:], (tag, key)
                if key in corr:
                    continue
                assert got.shape == want.shape, (tag, key)
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=f"{tag} {key}")
            same_correspondences(*((d[k].numpy() for k in corr) for d in (packed, single)),
                                 tag)


def test_tester_checks_its_arguments(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="dump_mode"):
        PortTester(Config(**SMALL, dump_mode="bogus"), dataset=SyntheticPairs(1, 128), device="cpu")
    with pytest.raises(ValueError, match="pretrain"):
        PortTester(Config(**SMALL), dataset=SyntheticPairs(1, 128), device="cpu")


def test_tester_warns_once_about_workers(tmp_path, monkeypatch, recwarn):
    monkeypatch.chdir(tmp_path)
    cfg = Config(**dict(SMALL, num_workers=4))
    PortTester(cfg, dataset=SyntheticPairs(2, 128, normal_knn=9), device="cpu",
           state_dict=port_and_params(0, **SMALL)[1].state_dict()).test()
    assert sum("num_workers" in str(w.message) for w in recwarn) == 1
    assert sorted(os.listdir(os.path.join("snapshot", cfg.exp_dir, cfg.benchmark))) == \
        ["0.pth", "1.pth"]


def test_get_trainer_dispatches_on_mode(tmp_path, monkeypatch):
    from roitr_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    ds = SyntheticPairs(1, 128, normal_knn=9)
    monkeypatch.setattr("roitr_torch.train.trainer.get_dataset", lambda cfg, mode: ds)
    assert isinstance(get_trainer(Config(**dict(SMALL, mode="train")), device="cpu"), Trainer)
    with pytest.raises(FileNotFoundError):  # test mode reads cfg.test_info
        get_trainer(Config(**dict(SMALL, test_info="missing.pkl", pretrain="w.pth")),
                    device="cpu")
