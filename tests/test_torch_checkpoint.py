"""The port's one weight loader, train/checkpoint.py `load_model_state`,
against the JAX package's reading of a reference RoITr `.pth`
(`load_torch_checkpoint` + `torch_state_dict_to_params`), and
`Matcher.from_checkpoint` against a Matcher given the same weights.

The reference `.pth` is built here, in the reference trainer's format: the
522 keys of tests/fixtures/ref_state_dict_keys.json (the port's seeded
weights, and seeded values for the entries the model never reads), a DDP
`module.` prefix and a `state_dict` wrapper. Weights compare bit for bit;
Matcher outputs exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.models.roitr import RoITr
from roitr_torch.serving import Matcher
from roitr_torch.train.checkpoint import load_model_state
from roitr_torch.utils.convert import params_to_state_dict
from roitr_tpu.utils.convert import load_torch_checkpoint, torch_state_dict_to_params

from torch_parity import TINY, one_torch_thread  # noqa: F401 (an autouse fixture)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_state_dict_keys.json")


def write_reference_pth(path, state_dict):
    """A reference RoITr checkpoint of these weights: every key of the
    reference's state_dict (the port's weights where the port has the key,
    seeded values where it does not), `module.`-prefixed, under
    "state_dict"."""
    shapes = json.load(open(FIXTURE))
    rng = np.random.RandomState(0)
    ref = {}
    for key, shape in shapes.items():
        value = state_dict[key] if key in state_dict else torch.from_numpy(
            np.asarray(rng.randn(*shape), np.float32))
        assert list(value.shape) == shape, key
        ref["module." + key] = value.clone()
    torch.save({"state_dict": ref, "epoch": 3}, path)


@pytest.fixture(scope="module")
def model():
    return RoITr(Config(**TINY, fine_matching_confidence_threshold=0.0), device="cpu", seed=7)


@pytest.fixture(scope="module")
def reference_pth(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "model_3dmatch.pth")
    write_reference_pth(path, model.state_dict())
    return path


def test_reference_pth_loads_as_jax_reads_it(model, reference_pth):
    """The port's loader and JAX's reading of the same file, mapped back
    to the port's keys, agree bit for bit, and give the weights written."""
    got = load_model_state(reference_pth)
    want = params_to_state_dict(torch_state_dict_to_params(load_torch_checkpoint(reference_pth)))
    assert set(got) == set(want) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(got[key], want[key]), key
        assert torch.equal(got[key], value), key
    RoITr(model.cfg, device="cpu", seed=1).load_state_dict(got)  # strict


def test_port_checkpoint_and_bare_state_dict_load(model, tmp_path):
    sd = model.state_dict()
    torch.save({"model": sd, "optimizer": {}, "step": 2, "epoch": 0, "best_metrics": {}},
               tmp_path / "model_0.pth")
    torch.save(sd, tmp_path / "bare.pth")
    for name in ("model_0.pth", "bare.pth"):
        got = load_model_state(str(tmp_path / name))
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd), name


def test_matcher_from_checkpoint_matches_matcher(model, reference_pth):
    rng = np.random.RandomState(8)
    src, tgt = rng.rand(230, 3).astype(np.float32), rng.rand(200, 3).astype(np.float32)
    want = Matcher(model.cfg, model.state_dict(), device="cpu", descriptors=True)
    got = Matcher.from_checkpoint(reference_pth, model.cfg, device="cpu", descriptors=True)
    with torch.no_grad():
        a, b = got.match(src, tgt), want.match(src, tgt)
    assert set(a) == set(b) and len(a["confidence"]) > 0
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
