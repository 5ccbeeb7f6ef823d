"""The port's spans (roitr_torch/utils/profiling.py) on the CPU: nothing
recorded without a profiler session; under one, a Matcher request's spans
nest and tile as documented and appear in the exported Chrome trace; a span
nested in its own name counts once; the record ring is bounded; the device
idle of a trace goes to the innermost span; and the benchmark's readers of
the spans (portbench/metrics/*_ms.*.py)."""

import collections
import types

import pytest
import torch

from roitr_torch.config import Config
from roitr_torch.models.roitr import RoITr
from roitr_torch.serving import Matcher
from roitr_torch.utils import profiling
from roitr_torch.utils.profiling import (
    reset_spans,
    span,
    span_records,
    span_summary,
    trace,
    trace_events,
)

from torch_parity import TINY, one_torch_thread, pair_arrays  # noqa: F401 (an autouse fixture)

REQUEST_CHILDREN = ["request.h2d", "request.normals", "request.forward", "request.d2h"]


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def test_span_without_a_profiler_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    reset_spans()
    for device in (True, False, "cpu", torch.device("cuda")):
        with span("idle", device):
            pass
    assert span("idle") is span("other", "cuda")  # the one no-op object
    assert span_records() == [] and span_summary() == {} and made == []


def test_matcher_request_spans_nest_tile_and_reach_the_chrome_trace(tmp_path):
    cfg = Config(**TINY)
    matcher = Matcher(cfg, RoITr(cfg, device="cpu", seed=1).state_dict(), device="cpu",
                      prep="device")
    arr = pair_arrays(3)
    n, m = int(arr["src_count"]), int(arr["tgt_count"])
    reset_spans()
    with trace(str(tmp_path)) as log_dir:
        matcher.match(arr["src_points"][:n], arr["tgt_points"][:m])
    recs = span_records()
    (request,) = [r for r in recs if r.name == "request"]
    children = lambda parent: [r.name for r in recs if r.parent is parent]  # noqa: E731
    assert request.parent is None and children(request) == REQUEST_CHILDREN
    assert all(r.root == request.root for r in recs)
    forward = next(r for r in recs if r.name == "request.forward")
    assert children(forward) == ["model.local", "model.transformer", "model.local",
                                 "model.matching"]
    matching = next(r for r in recs if r.name == "model.matching")
    assert "model.ot" in children(matching)
    assert {r.parent.name for r in recs if r.name == "knn"} >= {"request.normals", "model.local"}
    summary = span_summary()
    assert summary["request"]["calls"] == 1
    assert all(s["device_ms"] is None for s in summary.values())  # no device on the CPU
    kids = sum(summary[k]["host_ms"] for k in REQUEST_CHILDREN)
    assert kids <= summary["request"]["host_ms"]
    assert summary["request"]["self_host_ms"] == pytest.approx(
        summary["request"]["host_ms"] - kids, abs=1e-6)
    names = {e["name"] for e in trace_events(log_dir) if e.get("cat") == "user_annotation"}
    assert set(REQUEST_CHILDREN) | {"request", "model.local", "model.transformer",
                                    "model.matching", "model.ot", "knn", "fps"} <= names


def test_geotransformer_request_spans_nest_and_tile():
    """GeoTransformer's request: the prep span holds the grid pyramid's
    radius searches, the forward tiles into backbone (one `kpconv` a
    KPConv), transformer, matching (with the OT) and registration."""
    from portbench import pools
    from roitr_torch.models.geotransformer import GeoTransformer
    from roitr_torch.ops.grid import GRID_SEARCHES

    cfg = Config(model="geotransformer", fine_matching_confidence_threshold=0.0)
    matcher = Matcher(cfg, GeoTransformer(cfg, device="cpu").state_dict(), device="cpu",
                      prep="device")
    src, tgt = pools.request_pool(5, {"points": [900, 1100], "pool": 1, "overlap": 0.7})[0]
    reset_spans()
    _profiled(lambda: matcher.match(src, tgt))
    recs = span_records()
    (request,) = [r for r in recs if r.name == "request"]
    children = lambda parent: [r.name for r in recs if r.parent is parent]  # noqa: E731
    assert children(request) == ["request.h2d", "request.prep", "request.forward", "request.d2h"]
    forward = next(r for r in recs if r.name == "request.forward")
    assert children(forward) == ["model.backbone", "model.transformer", "model.matching",
                                 "model.lgr"]
    backbone = next(r for r in recs if r.name == "model.backbone")
    assert children(backbone) == ["kpconv"] * 11
    prep = next(r for r in recs if r.name == "request.prep")
    assert children(prep) == ["knn"] * GRID_SEARCHES
    assert "model.ot" in children(next(r for r in recs if r.name == "model.matching"))
    assert all(r.root == request.root for r in recs)


def test_nested_same_name_counts_once_and_the_ring_is_bounded(monkeypatch):
    reset_spans()
    laps = {}

    def run():
        with span("knn", "cpu"):
            with span("knn", "cpu"):
                with span("inner", False):
                    pass
        with span("train.forward", "cpu", laps):
            pass

    _profiled(run)
    summary = span_summary()
    assert summary["knn"]["calls"] == 1 and summary["inner"]["calls"] == 1
    (inner,) = [r for r in span_records() if r.name == "inner"]
    assert inner.parent.name == "knn" and inner.parent.parent is None
    assert summary["knn"]["self_host_ms"] <= summary["knn"]["host_ms"]
    assert set(laps) == {"forward_ms"} and laps["forward_ms"] >= 0.0
    assert profiling._records.maxlen == profiling.RING
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=8))

    def many():
        for i in range(20):
            with span(f"s{i}", False):
                pass

    _profiled(many)
    assert [r.name for r in span_records()] == [f"s{i}" for i in range(12, 20)]


def test_device_idle_goes_to_the_innermost_open_span():
    host = lambda name, ts, dur, cat="user_annotation": dict(  # noqa: E731
        ph="X", name=name, ts=ts, dur=dur, cat=cat)
    events = [host("request", 0, 100), host("knn", 10, 40), host("aten::add", 12, 2, "cpu_op"),
              host("k1", 0, 10, "kernel"), host("k2", 60, 30, "kernel"),
              host("gpu_user_annotation", 0, 100, "gpu_user_annotation")]
    idle = profiling.device_idle_by_span(events, names=("request", "knn"))
    assert idle == pytest.approx({"knn": 0.05, "request": 0.01})
    assert profiling.device_idle_by_span(events[3:5], names=()) == {}
    events.append(host("later", 120, 10, "cpu_op"))
    assert profiling.device_idle_by_span(events, names=("knn",))[profiling.OUTSIDE] == \
        pytest.approx(0.01 + 0.03)


SPAN_METRICS = {  # metric: (span, field, per request)
    "normals_ms.match": ("request.normals", "device_ms", True),
    "local_ms.match": ("model.local", "device_ms", True),
    "transformer_ms.match": ("model.transformer", "device_ms", True),
    "matching_ms.match": ("model.matching", "device_ms", True),
    "knn_ms.match": ("knn", "device_ms", True),
    "enqueue_ms.match": ("request.forward", "host_ms", True),
    "knn_ms.train": ("knn", "device_ms", False),
    "loader_wait_ms.train": ("loader.wait", "host_ms", False),
    "prep_ms.geomatch": ("request.prep", "device_ms", True),
    "backbone_ms.geomatch": ("model.backbone", "device_ms", True),
    "kpconv_ms.geomatch": ("kpconv", "device_ms", True),
    "lgr_ms.geomatch": ("model.lgr", "device_ms", True),
}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_metric_reads_the_mean_a_pair(metric, monkeypatch):
    from portbench.harness import load_metric

    name, field, per_request = SPAN_METRICS[metric]
    read = load_metric(metric).read
    run = lambda device, trace: types.SimpleNamespace(  # noqa: E731
        ctx=types.SimpleNamespace(device=device), trace=trace)
    stretch = {"counts": [(20000, 25000)] * 4}
    summary = {n: {"calls": 4, "host_ms": 40.0, "self_host_ms": 4.0, "device_ms": 400.0}
               for n in ("request", name)}
    summary[name][field] = 123.0
    monkeypatch.setattr(profiling, "span_summary", lambda: summary)
    assert read(run("cuda", stretch)) == pytest.approx(123.0 / 4)
    assert read(run("cpu", stretch)) is None and read(run("cuda", None)) is None
    summary["request"]["calls"] = 5  # a request without its span, or one too many
    assert (read(run("cuda", stretch)) is None) == per_request
    summary.pop(name)
    assert read(run("cuda", stretch)) is None
