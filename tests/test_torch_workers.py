"""The port's preprocessing worker pool (roitr_torch/data/worker_pool.py,
worker_main.py) on the CPU: `python -S -m roitr_torch.data.worker_main`
subprocesses that get the dataset once and indices after it, each
answering in order.

- Items come back in the order asked, equal to the in-process items, from
  the 3DMatch dataset with host pyramids (whose native library the parent
  builds before the workers start).
- Workers see no CUDA device and run one intra-op thread.
- A worker's exception is raised in the parent with its traceback; a
  worker that dies raises too; neither falls back to preparing in process.
- A Trainer with two workers trains to the same parameters as with none.
(The loader with workers against the in-process loader and JAX's:
tests/test_torch_packed_train.py; the Tester's dumps byte for byte:
tests/test_torch_tester.py::test_tester_warns_once_about_workers.)
"""

import os
import pickle

import numpy as np
import pytest
import torch

from roitr_torch import native
from roitr_torch.config import Config
from roitr_torch.data import get_dataset
from roitr_torch.data.synthetic import SyntheticPairs, make_pair_arrays
from roitr_torch.data.worker_pool import WorkerPool
from roitr_torch.train.trainer import Trainer

from torch_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from worker_probe import WorkerProbe


def _assert_items_equal(got, want, tag):
    assert set(got) == set(want), tag
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "_asdict"):  # a host pyramid
            for f, x in w._asdict().items():
                np.testing.assert_array_equal(getattr(g, f), x, err_msg=f"{tag} {k}.{f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {k}")


def test_pool_runs_the_3dmatch_dataset_off_the_card(tmp_path, monkeypatch):
    """TDMatchDataset (the .pth layout, host pyramids) pickled into a
    worker: the parent builds the native library first; the items come in
    order and equal the in-process ones array for array; the worker, which
    imported torch to read the fragments, sees no CUDA device and runs one
    thread. The data root is relative: a worker reads from the parent's
    working directory. (Two workers' round robin: the Trainer test below
    and tests/test_torch_packed_train.py's loader test.)"""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    os.makedirs("data/test")
    for i in range(3):
        arr = make_pair_arrays(rng, 256, 200 + 10 * i, 180)
        for j, (pts, n) in enumerate(((arr["src_points"], 200 + 10 * i), (arr["tgt_points"], 180))):
            torch.save(torch.from_numpy(pts[:n].copy()), f"data/test/c{2 * i + j}.pth")
        infos["src"].append(f"test/c{2 * i}.pth")
        infos["tgt"].append(f"test/c{2 * i + 1}.pth")
        infos["rot"].append(arr["rot"])
        infos["trans"].append(arr["trans"])
        infos["overlap"].append(0.5)
    with open("info.pkl", "wb") as f:
        pickle.dump(infos, f)
    cfg = Config(buckets=(256,), points_limit=256, normal_knn=9, host_pyramid=True,
                 root="data", test_info="info.pkl")
    ds = get_dataset(cfg, "test")
    built = []
    build = native.build
    monkeypatch.setattr(native, "build", lambda: built.append(1) or build())
    probe = WorkerProbe(3, inner=ds)
    probe.config = cfg  # the pool reads host_pyramid from the dataset's config
    with WorkerPool(probe, 1) as pool:
        assert built == [1]
        items = list(pool.imap([2, 0, 1]))
    assert [d.pop("index") for d in items] == [2, 0, 1]
    assert len({d.pop("pid") for d in items}) == 1
    for i, item in zip([2, 0, 1], items):
        seen = {k: item.pop(k) for k in ("cuda_visible", "omp", "threads", "cuda")}
        assert seen == {"cuda_visible": "", "omp": "1", "threads": 1, "cuda": False}, seen
        assert item["src_pyramid"] is not None
        _assert_items_equal(item, ds[i], f"item {i}")


def test_worker_error_raises_in_the_parent_with_its_traceback():
    with WorkerPool(WorkerProbe(3, raise_at=1), 1) as pool:
        it = pool.imap(range(3))
        assert next(it)["index"] == 0
        with pytest.raises(RuntimeError, match="(?s)raised on index 1.*Traceback.*"
                                               "ValueError: probe raised on index 1"):
            next(it)


def test_dead_worker_raises():
    with WorkerPool(WorkerProbe(4, exit_at=1), 1) as pool:
        it = pool.imap(range(4))
        assert next(it)["index"] == 0
        with pytest.raises(RuntimeError, match=r"worker 0 died \(exit 3\) before answering "
                                               "index 1"):
            next(it)


def test_trainer_with_workers_matches_in_process(tmp_path, monkeypatch):
    """An epoch of two train steps with the pairs prepared by two workers
    and in process: the same metrics and parameters, bit for bit."""
    monkeypatch.chdir(tmp_path)
    base = dict(num_est_coarse_corr=8, num_gt_coarse_corr=8, point_per_patch=8,
                sinkhorn_iters=5, max_gt_corr_candidates=16, buckets=(128,), normal_knn=9,
                max_epoch=1, verbose=False, training_max_iter=2)
    runs = []
    for workers in (2, 0):
        cfg = Config(**base, num_workers=workers, exp_dir=f"workers{workers}")
        trainer = Trainer(cfg, SyntheticPairs(2, 128, seed=0, normal_knn=9),
                          SyntheticPairs(1, 128, seed=50, normal_knn=9), device="cpu")
        runs.append((trainer.train_epoch(0), trainer.model.state_dict()))
    (metrics2, sd2), (metrics0, sd0) = runs
    assert metrics2 == metrics0
    for k, v in sd0.items():
        assert torch.equal(sd2[k], v), k
