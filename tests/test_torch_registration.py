"""The port's registration evaluation (roitr_torch/eval/registration.py,
trajectory.py, benchmark.py, ransac.py, ransac_torch.py) against the JAX
package's, on the CPU.

- The numpy copies equal JAX's bit for bit: Kabsch, the quaternion, the
  Redwood error, trajectory files read and written, the scene benchmark on
  a TinyMatch ground-truth folder, the inlier ratio and the numpy RANSAC.
- The torch RANSAC on the CPU against the port's numpy RANSAC and JAX's
  ransac_jax on tests/test_eval.py's two scenes: the noisy one within 5e-3
  (JAX's own bound there), and the ranking one within 1e-4 with the
  count-9 winner. Both scenes hold at most 512 correspondences and run
  8192 hypotheses, so JAX compiles one program.
- Both protocols with ransac_backend "torch" give the numpy backend's
  registration recall, inlier ratio and feature-match recall on the
  port's own Tester dumps; "torch" on the card is their default.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.data.synthetic import SyntheticPairs
from roitr_torch.eval.benchmark import benchmark as port_benchmark
from roitr_torch.eval import ransac as port_ransac
from roitr_torch.eval import trajectory as port_traj
from roitr_torch.eval.ransac_torch import (
    best_hypothesis,
    ransac_pose_estimation_correspondences_torch,
)
from roitr_torch.eval.registration import (
    _ransac_fn,
    benchmark_registration,
    benchmark_registration_rotated,
    resolve_gt_folder,
)
from roitr_torch.eval.tester import Tester as PortTester
from roitr_torch.models.roitr import RoITr
from roitr_tpu.eval.benchmark import benchmark as jax_benchmark
from roitr_tpu.eval import ransac as jax_ransac
from roitr_tpu.eval import trajectory as jax_traj
from roitr_tpu.eval.ransac_jax import ransac_pose_estimation_correspondences_jax

from torch_parity import TINY, one_torch_thread  # noqa: F401 (an autouse fixture)


def rand_rot(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


def test_kabsch_and_inlier_ratio_equal_jax(rng):
    src = rng.randn(5, 10, 3)
    tgt = np.einsum("bij,bnj->bni", np.stack([rand_rot(rng) for _ in range(5)]), src)
    tgt += rng.randn(5, 1, 3) + rng.randn(5, 10, 3) * 0.01
    w = rng.rand(5, 10)
    for args in ((src, tgt), (src, tgt, w), (src[0], tgt[0])):
        for a, b in zip(port_ransac.kabsch(*args), jax_ransac.kabsch(*args)):
            np.testing.assert_array_equal(a, b)
    rot, trans = rand_rot(rng), rng.randn(3, 1)
    for s, t in ((src[0], tgt[0]), (src[0][:0], tgt[0][:0])):
        assert (port_ransac.get_inlier_ratio_correspondence(s, t, rot, trans, 0.5)
                == jax_ransac.get_inlier_ratio_correspondence(s, t, rot, trans, 0.5))


def test_quaternion_and_redwood_error_equal_jax(rng):
    mats = [rand_rot(rng) for _ in range(20)]
    # each branch of Shepperd's method: trace > 0, and each axis the largest
    mats += [np.diag(d) for d in
             ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))]
    for m in mats:
        np.testing.assert_array_equal(port_traj.mat2quat(m), jax_traj.mat2quat(m))
        t = np.eye(4)
        t[:3, :3], t[:3, 3] = m, rng.randn(3)
        info = np.cov(rng.randn(6, 20)) * 100
        assert (port_traj.compute_transformation_error(t, info)
                == jax_traj.compute_transformation_error(t, info))
    r1, r2 = np.stack(mats[:5]), np.stack(mats[5:10])
    np.testing.assert_array_equal(port_traj.rotation_error_deg(r1, r2),
                                  jax_traj.rotation_error_deg(r1, r2))
    t1, t2 = rng.randn(5, 3, 1), rng.randn(5, 3, 1)
    np.testing.assert_array_equal(port_traj.translation_error(t1, t2),
                                  jax_traj.translation_error(t1, t2))


def _write_scene(gt_dir, scene, transforms, n_frag=8):
    """gt.log / gt.info of one scene whose pair p is fragments (p, p + 2)."""
    os.makedirs(os.path.join(gt_dir, scene), exist_ok=True)
    log, info = [], []
    for p, t in enumerate(transforms):
        log += [f"{p}\t{p + 2}\t{n_frag}"] + ["\t".join(f"{v:.12f}" for v in row) for row in t]
        info += [f"{p}\t{p + 2}\t{n_frag}"] + ["\t".join(f"{v:.6f}" for v in row)
                                              for row in np.eye(6) * 100]
    with open(os.path.join(gt_dir, scene, "gt.log"), "w") as f:
        f.write("\n".join(log) + "\n")
    with open(os.path.join(gt_dir, scene, "gt.info"), "w") as f:
        f.write("\n".join(info) + "\n")


def test_trajectories_and_benchmark_equal_jax(tmp_path, rng):
    """Ground truth of two scenes, estimates (some off by a metre) written
    by the port's write_est_trajectory: every file the two packages read
    and write, and the benchmark's aggregates and result file, are equal."""
    gt_dir = str(tmp_path / "gt")
    gts = []
    for scene in ("sceneA", "sceneB"):
        ts = []
        for _ in range(4):
            t = np.eye(4)
            t[:3, :3], t[:3, 3] = rand_rot(rng), rng.randn(3)
            ts.append(t)
        _write_scene(gt_dir, scene, ts)
        gts += ts
    est = np.stack(gts)
    est[[1, 5, 6], :3, 3] += 1.0
    for pkg, out in ((port_traj, "port"), (jax_traj, "jax")):
        pkg.write_est_trajectory(gt_dir, str(tmp_path / out), est)
    for scene in ("sceneA", "sceneB"):
        for name in ("gt/{s}/gt.log", "port/{s}/est.log"):
            path = str(tmp_path / name.format(s=scene))
            for a, b in zip(port_traj.read_trajectory(path), jax_traj.read_trajectory(path)):
                np.testing.assert_array_equal(a, b)
        info = str(tmp_path / "gt" / scene / "gt.info")
        a, b = port_traj.read_trajectory_info(info), jax_traj.read_trajectory_info(info)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        assert ((tmp_path / "port" / scene / "est.log").read_text()
                == (tmp_path / "jax" / scene / "est.log").read_text())
    res = {out: fn(str(tmp_path / out), gt_dir)
           for fn, out in ((port_benchmark, "port"), (jax_benchmark, "jax"))}
    assert res["port"] == res["jax"] and 0 < res["port"]["mean_recall"] < 1
    assert (tmp_path / "port" / "result").read_text() == (tmp_path / "jax" / "result").read_text()


def _noisy_scene():
    """tests/test_eval.py's scene at 500 correspondences: a third outliers."""
    rng = np.random.RandomState(0)
    n = 500
    src = rng.randn(n, 3)
    q = rand_rot(rng)
    t_gt = rng.randn(3) * 0.5
    tgt = src @ q.T + t_gt + rng.randn(n, 3) * 0.005
    out_idx = rng.permutation(n)[: n // 3]
    tgt[out_idx] += rng.randn(len(out_idx), 3) * 2.0
    return src, tgt, q, t_gt


def _ranking_scene():
    """tests/test_eval.py's ranking regression: 3 exact anchors and 6
    points offset by 1.4 make a count-9, high-RMSE identity hypothesis; 8
    points translated by u a count-8, RMSE-0 one. At threshold 1.5 a
    combined count - rmse score would pick the latter."""
    rng2 = np.random.RandomState(1)
    anchors = rng2.randn(3, 3) * 5
    offs_src = rng2.randn(6, 3) * 5
    dirs = rng2.randn(6, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    u = np.array([40.0, 0.0, 0.0])
    u_src = rng2.randn(8, 3) * 5
    return (np.concatenate([anchors, offs_src, u_src]),
            np.concatenate([anchors, offs_src + 1.4 * dirs, u_src + u]))


@pytest.fixture(scope="module")
def scenes():
    src, tgt, q, t_gt = _noisy_scene()
    src2, tgt2 = _ranking_scene()
    kw = dict(max_iterations=8192, seed=3)
    kw2 = dict(max_iterations=8192, seed=7, distance_threshold=1.5)
    return {
        "noisy": {"numpy": port_ransac.ransac_pose_estimation_correspondences(src, tgt, **kw),
                  "jax_numpy": jax_ransac.ransac_pose_estimation_correspondences(src, tgt, **kw),
                  "jax": ransac_pose_estimation_correspondences_jax(src, tgt, **kw),
                  "torch": ransac_pose_estimation_correspondences_torch(src, tgt, device="cpu",
                                                                        **kw),
                  "gt": (q, t_gt)},
        "ranking": {"numpy": port_ransac.ransac_pose_estimation_correspondences(src2, tgt2,
                                                                               **kw2),
                    "jax": ransac_pose_estimation_correspondences_jax(src2, tgt2, **kw2),
                    "torch": ransac_pose_estimation_correspondences_torch(
                        src2, tgt2, device="cpu", **kw2),
                    "points": (src2, tgt2)},
    }


def test_numpy_ransac_equals_jax_s(scenes):
    np.testing.assert_array_equal(scenes["noisy"]["numpy"], scenes["noisy"]["jax_numpy"])


def test_torch_ransac_on_the_noisy_scene(scenes):
    s = scenes["noisy"]
    for other in ("numpy", "jax"):
        np.testing.assert_allclose(s["torch"], s[other], atol=5e-3, err_msg=other)
    q, t_gt = s["gt"]
    t = s["torch"]
    assert np.degrees(np.arccos(np.clip((np.trace(t[:3, :3] @ q.T) - 1) / 2, -1, 1))) < 0.1
    assert np.linalg.norm(t[:3, 3] - t_gt) < 0.01


def test_torch_ransac_ranks_by_count_then_rmse(scenes):
    s = scenes["ranking"]
    for other in ("numpy", "jax"):
        np.testing.assert_allclose(s["torch"], s[other], atol=1e-4, err_msg=other)
    src2, tgt2 = s["points"]
    t = s["torch"]
    d = np.linalg.norm(src2 @ t[:3, :3].T + t[:3, 3] - tgt2, axis=1)
    assert (d[:9] < 2.5).all() and (d[9:] > 30).all()
    # the winner itself: 9 inliers, the identity class
    idx = np.random.RandomState(7).randint(0, len(src2), size=(8192, 3))
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    r, _, count, best = best_hypothesis(f(src2), f(tgt2), torch.from_numpy(idx), 1.5)
    assert count == 9 and set(idx[best]) <= set(range(9))
    np.testing.assert_allclose(r.numpy(), np.eye(3), atol=1e-3)


def test_torch_ransac_degenerate_inputs():
    eye = np.eye(4)
    np.testing.assert_array_equal(ransac_pose_estimation_correspondences_torch(
        np.zeros((2, 3)), np.zeros((2, 3)), device="cpu"), eye)
    # every triplet of repeated points fails the edge-length checker
    np.testing.assert_array_equal(ransac_pose_estimation_correspondences_torch(
        np.ones((20, 3)), np.ones((20, 3)), max_iterations=300, device="cpu"), eye)
    with pytest.raises(ValueError, match="ransac_backend='torch'"):
        _ransac_fn("jax")


@pytest.mark.parametrize("protocol", [benchmark_registration, benchmark_registration_rotated])
def test_protocols_run_ransac_on_the_card_by_default(protocol):
    """A caller who does not ask for the host gets the torch RANSAC on the
    card; numpy runs only on request."""
    params = inspect.signature(protocol).parameters
    assert params["ransac_backend"].default == "torch"
    assert params["device"].default == "cuda"


def test_resolve_gt_folder_finds_the_vendored_scenes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # found from the package, whatever the directory
    for name in ("3DMatch", "3DLoMatch"):
        folder = resolve_gt_folder(name)
        scenes = sorted(os.listdir(folder))
        assert len(scenes) == 8
        for s in scenes:
            assert os.path.isfile(os.path.join(folder, s, "gt.log"))
            assert os.path.isfile(os.path.join(folder, s, "gt.info"))
    with pytest.raises(FileNotFoundError):
        resolve_gt_folder("NoSuchBenchmark")


SMALL = dict(TINY, sinkhorn_iters=5, buckets=(256,), mode="test", num_workers=0,
             fine_matching_confidence_threshold=0.0)


def test_protocols_with_either_backend_on_the_port_s_dumps(tmp_path, monkeypatch):
    """The Tester's dumps of three pairs, a TinyMatch scene with their GT:
    both protocols give the same numbers with either RANSAC backend."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(**SMALL)
    PortTester(cfg, dataset=SyntheticPairs(3, 256, normal_knn=9), device="cpu",
               state_dict=RoITr(cfg, device="cpu", seed=0).state_dict()).test()
    dump_dir = os.path.join("snapshot", cfg.exp_dir, cfg.benchmark)
    transforms = []
    for i in range(3):
        d = torch.load(os.path.join(dump_dir, f"{i}.pth"), weights_only=False)
        assert d["src_corr_pts"].shape[0] > 64
        t = np.eye(4)
        t[:3, :3], t[:3, 3] = d["rot"].numpy(), d["trans"].numpy().ravel()
        transforms.append(t)
    _write_scene(str(tmp_path / "gt" / "TinyMatch"), "scene0", transforms)
    res = {}
    for backend in ("numpy", "torch"):
        kw = dict(n_points=64, ransac_iterations=2000, seed=0, ransac_backend=backend,
                  device="cpu")
        res[backend] = (
            benchmark_registration(dump_dir, str(tmp_path / backend), "TinyMatch",
                                   gt_folder=str(tmp_path / "gt" / "TinyMatch"), **kw),
            benchmark_registration_rotated(dump_dir, str(tmp_path / backend), "TinyMatch",
                                           **kw))
    assert res["torch"] == res["numpy"]
    for r in res["torch"]:
        assert all(np.isfinite(v) for v in r.values())
