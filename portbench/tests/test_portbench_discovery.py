"""BENCHMARK.json against the contract's shape and the files it names; the
configurations, cells, traffic and metrics found by name."""

import json
import re

import pytest

from portbench import harness, models
from portbench.harness import HERE, ROOT
from portbench.tests.helpers import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in b["configs"])) == len(b["configs"])
    assert len(set(x["name"] for x in b["workloads"])) == len(b["workloads"])
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def test_files_named_exist_and_are_found_by_name():
    b = bench()
    for c in b["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.resolve().is_relative_to(HERE)
        assert path == HERE / "configs" / f"{c['name']}.json"  # found by its name
        config = json.loads(path.read_text())
        model = models.load(config.get("model", models.DEFAULT), c["file"])
        model.program_config(config["config"])  # every value is one the program takes
    for w in b["workloads"]:
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        ctx = harness.make_context(b, w["name"], 1, "cpu")
        assert ctx.model is models.load(ctx.model_name)
        module = harness.driver_module(ctx)
        assert hasattr(module, "Driver") or hasattr(module, "run")
        assert callable(module.reference_numbers)
        assert w["chips"] in (1, 4)
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert mod.NAME == m["name"] and mod.UNIT == m["unit"] and callable(mod.read)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    b = bench()
    e2e = {m["name"] for m in harness.cell_metrics(b, cell, trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(b, cell, trace=True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_reference_and_harness_import_no_program():
    """The reference's modules, the harness, the drivers and the control
    load neither the program nor JAX when imported."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.refproc, portbench.control, portbench.judge\n"
            "import portbench.models, portbench.models.roitr\n"
            "import portbench.reference.pipeline, portbench.weights, portbench.trace\n"
            "import portbench.drivers.match, portbench.drivers.train, portbench.drivers.train_dp\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'roitr_tpu', 'roitr_torch'}\n"
            "assert not bad, bad\n") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True)


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "roitr_tpu_like", types.ModuleType("roitr_tpu_like"))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.loaded_forbidden() == ["jax"]
