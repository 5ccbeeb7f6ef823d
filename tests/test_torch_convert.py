"""The port's state_dict layout and its converter from JAX params.

The port's modules must yield the reference RoITr state_dict keys
(tests/fixtures/ref_state_dict_keys.json) less the entries the model never
reads, and `params_to_state_dict` must invert the JAX package's
`torch_state_dict_to_params` exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.models.roitr import RoITr
from roitr_torch.utils.convert import (
    SKIP_PATTERNS,
    load_reference_state_dict,
    params_to_state_dict,
)
from roitr_tpu.utils.convert import torch_state_dict_to_params

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_state_dict_keys.json")


@pytest.fixture(scope="module")
def ref_shapes():
    return json.load(open(FIXTURE))


@pytest.fixture(scope="module")
def fake_state_dict(ref_shapes):
    rng = np.random.RandomState(0)
    return {k: rng.randn(*shp).astype(np.float32) if shp else np.float32(rng.randn())
            for k, shp in ref_shapes.items()}


@pytest.fixture(scope="module")
def port_model():
    return RoITr(Config(benchmark="3DMatch"), device="cpu", seed=0)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def test_state_dict_keys_and_shapes_match_reference(port_model, ref_shapes):
    want = {k: v for k, v in ref_shapes.items() if not any(p.search(k) for p in SKIP_PATTERNS)}
    sd = port_model.state_dict()
    assert set(sd) == set(want)
    for k, shape in want.items():
        assert list(sd[k].shape) == shape, k


def test_params_round_trip_is_exact(fake_state_dict):
    params = torch_state_dict_to_params(fake_state_dict)
    again = torch_state_dict_to_params(params_to_state_dict(params))
    a, b = _leaves(params), _leaves(again)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_converted_params_load_into_port(fake_state_dict, port_model):
    params = torch_state_dict_to_params(fake_state_dict)
    model = RoITr(Config(benchmark="3DMatch"), device="cpu", seed=1)
    model.load_state_dict(params_to_state_dict(params))  # strict: every key, every shape
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["backbone.global_transformer.transformer.layers.0.attention.attention.proj_p.weight"],
        fake_state_dict[
            "backbone.global_transformer.transformer.layers.0.attention.attention.proj_p.weight"])
    assert float(sd["optimal_transport.alpha"]) == pytest.approx(
        float(fake_state_dict["optimal_transport.alpha"]))


def test_reference_checkpoint_loads_after_skips(fake_state_dict):
    prefixed = {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in fake_state_dict.items()}
    model = RoITr(Config(benchmark="3DMatch"), device="cpu", seed=2)
    model.load_state_dict(load_reference_state_dict(prefixed))
    got = model.state_dict()["coarse_proj.weight"].numpy()
    np.testing.assert_array_equal(got, fake_state_dict["coarse_proj.weight"])


def test_port_init_is_seeded():
    a = RoITr(Config(), device="cpu", seed=3).state_dict()
    b = RoITr(Config(), device="cpu", seed=3).state_dict()
    c = RoITr(Config(), device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fine_proj.weight"], c["fine_proj.weight"])


def test_entry_point_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoITr(Config())


@pytest.mark.parametrize("source", ["3DMatch", "4DMatch", "configs/test/tdmatch.yaml",
                                    "configs/test/fdmatch.yaml", "configs/train/tdmatch.yaml"])
def test_config_copy_matches_jax_config(source):
    """The port's own Config / load_config give the JAX package's fields and
    values, for both benchmarks' defaults and the repo's YAML files."""
    import dataclasses

    from roitr_torch.config import load_config
    from roitr_tpu.config import Config as JaxConfig
    from roitr_tpu.config import load_config as jax_load_config

    if source.endswith(".yaml"):
        path = os.path.join(os.path.dirname(__file__), "..", source)
        got, want = load_config(path), jax_load_config(path)
    else:
        got, want = Config(benchmark=source), JaxConfig(benchmark=source)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
