"""The model registry: a configuration file that names its model reaches
that model's module (`portbench/models/<model>.py`) in `make_context`, in
`run_cell`'s set-up and in the reference's process, and builds no RoITr;
a model that has no module fails in `make_context`, naming the file and
the model."""

import re
import sys

import pytest

from portbench import harness, refproc
from portbench.tests import toy_model
from portbench.tests.helpers import SEED

BENCH = {"workloads": [{"name": "toy.sum", "config": "toy", "traffic": "toy", "chips": 1}],
         "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                         "source": "host_clock"},
                        {"name": "match_pairs_per_s", "unit": "pairs/s", "better": "higher",
                         "bound": 0.25, "source": "host_clock"}],
         "per_layer": []}


def toy_files(monkeypatch, model="toy", offset=0.0):
    """The toy cell's configuration, traffic and limits, served in place of
    files; the toy module registered as a model and as a driver."""
    files = {("configs", "toy.json"): {"model": model, "config": {"width": 64, "offset": offset}},
             ("traffic", "toy.json"): {"driver": "toy", "trace_steps": 1},
             ("workloads", "toy.sum.json"): {"limits": {"gap": 1e-4}}}
    real = harness.load_json
    monkeypatch.setattr(harness, "load_json", lambda *parts: files.get(parts) or real(*parts))
    monkeypatch.setitem(sys.modules, "portbench.models.toy", toy_model)
    monkeypatch.setitem(sys.modules, "portbench.drivers.toy", toy_model)
    monkeypatch.setattr(toy_model, "CALLS", [])


@pytest.mark.parametrize("offset,correct", [(0.0, True), (0.01, False)])
def test_a_named_model_is_reached_in_every_process_and_no_roitr_is_built(monkeypatch, offset,
                                                                         correct):
    from portbench.reference.model import RoITrReference

    built = []

    def refused(self, *a, **kw):
        built.append(a)
        raise AssertionError("a RoITr reference was built for the toy model")

    monkeypatch.setattr(RoITrReference, "__init__", refused)
    toy_files(monkeypatch, offset=offset)
    # the reference's process, called in this one (a spawned process would not
    # hold the toy's registration); other tests of the session load the program
    monkeypatch.setattr(harness, "reference_numbers",
                        lambda ctx, payload: refproc.numbers(harness.reference_job(ctx, payload)))
    monkeypatch.setattr(harness, "loaded_forbidden", lambda extra=(): [])

    ctx = harness.make_context(BENCH, "toy.sum", SEED, "cpu")
    assert ctx.model is toy_model and ctx.model_name == "toy"
    assert toy_model.CALLS == ["reference_config"]
    toy_model.CALLS.clear()
    res = harness.run_cell(BENCH, "toy.sum", SEED, 0.05, False, "cpu", harness.process_age_s(),
                           log=lambda *a: None)
    assert toy_model.CALLS == ["reference_config", "program_config", "make_state_dict",
                               "reference_config", "make_state_dict", "build_reference"]
    assert res["correct"] is correct and res["failed"] == 0
    assert res["compared"]["gap"]["value"] == pytest.approx(offset, abs=1e-5)
    assert set(res["metrics"]) == {"setup_s", "match_pairs_per_s"}
    assert not built


@pytest.mark.parametrize("name", ["no_such_model", "no-such-model", "../roitr"])
def test_a_model_without_a_module_fails_naming_the_file_and_the_model(monkeypatch, name):
    toy_files(monkeypatch, model=name)
    with pytest.raises((LookupError, ValueError),
                       match=re.escape("portbench/configs/toy.json") + ".*" + re.escape(repr(name))):
        harness.make_context(BENCH, "toy.sum", SEED, "cpu")


def test_a_configuration_without_a_model_is_roitr():
    from portbench.models import roitr
    from portbench.tests.helpers import bench

    ctx = harness.make_context(bench(), "3dmatch.match", SEED, "cpu")
    assert ctx.model is roitr and ctx.model_name == "roitr"
    job = harness.reference_job(ctx, {})
    assert job["model"] == "roitr" and "model" not in job["values"]
