"""The port's command line end to end on the CPU, the JAX package's loop of
tests/test_end_to_end.py through `python -m roitr_torch`: train one epoch
of 2 iterations on a tiny 3DMatch split in the reference layout, test from
the epoch's checkpoint, then the registration evaluation over the dumps.

The split and the configs are the JAX test's own (`_write_dataset`,
`_write_config`), with the pairs prepared in process (`num_workers` 0).
Training runs `main(argv)` in this process; test mode runs in one
subprocess, and its dumps must equal, byte for byte, those of an
in-process Tester given the checkpoint's weights.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import yaml

from roitr_torch.config import load_config
from roitr_torch.eval import registration
from roitr_torch.eval.tester import Tester as PortTester
from roitr_torch.main import main
from roitr_torch.train.checkpoint import load_model_state

from test_end_to_end import REPO, _write_config, _write_dataset
from torch_parity import one_torch_thread  # noqa: F401 (an autouse fixture)


def _port_config(tmp_path, root, info_path, mode, **model):
    path = _write_config(tmp_path, root, info_path, mode)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["train"]["num_workers"] = 0
    raw["model"].update(model)
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def test_cli_train_test_eval(tmp_path, monkeypatch, capsys):
    root, info_path, gt_folder = _write_dataset(tmp_path, np.random.RandomState(42))
    monkeypatch.chdir(tmp_path)
    snapshot = tmp_path / "snapshot" / "e2e"

    # ---- train one epoch through the CLI, in this process
    main([_port_config(tmp_path, root, info_path, "train"), "--device", "cpu"])
    ckpts = os.listdir(snapshot / "checkpoints")
    assert "model_0.pth" in ckpts and "model_best_loss.pth" in ckpts
    assert (snapshot / "src" / "roitr_torch" / "main.py").exists()

    # ---- test from the checkpoint: `python -m roitr_torch` in a subprocess
    ckpt = str(snapshot / "checkpoints" / "model_0.pth")
    cfg_test = _port_config(tmp_path, root, info_path, "test", pretrain=ckpt)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "roitr_torch", cfg_test, "--device", "cpu"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    dump_dir = snapshot / "3DMatch"
    names = ["0.pth", "1.pth", "2.pth"]
    assert sorted(os.listdir(dump_dir)) == names

    # ---- the same weights in an in-process Tester: the same bytes
    cfg = load_config(cfg_test).replace(exp_dir="in_process")
    PortTester(cfg, state_dict=load_model_state(ckpt), device="cpu").test()
    in_process = tmp_path / "snapshot" / "in_process" / "3DMatch"
    _, mismatch, errors = filecmp.cmpfiles(dump_dir, in_process, names, shallow=False)
    assert not mismatch and not errors

    # ---- the registration evaluation over the CLI's dumps
    capsys.readouterr()
    registration.main(["--source_path", str(dump_dir), "--benchmark", "3DMatch",
                       "--n_points", "100", "--gt_folder", gt_folder,
                       "--exp_dir", str(tmp_path / "est"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "inlier_ratio" in out and "mean_recall" in out
    assert (tmp_path / "est" / "3DMatch" / "100" / "result").exists()
