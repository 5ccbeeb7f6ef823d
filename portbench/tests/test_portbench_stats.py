"""The statistics and the trace reduction on synthetic inputs."""

import types

import pytest

from portbench import readers, stats, trace


def _run(records, window_s):
    return types.SimpleNamespace(records=records, window_s=window_s, trace=None, laps=None)


def test_p90_is_over_every_request():
    # 20 requests: 18 of 100 ms and 2 of 1000 ms; p90 between order statistics 18 and 19
    recs = [(i, i + 0.1, 1, False) for i in range(18)] + [(20, 21.0, 1, False), (22, 23.0, 1, False)]
    assert readers.request_p90_ms(_run(recs, 23.0)) == pytest.approx(100 + 0.1 * 900)
    assert stats.p90(list(range(1, 11))) == pytest.approx(9.1)


def test_rate_is_all_work_over_the_window():
    recs = [(0.0, 0.5, 1, False), (0.5, 1.5, 1, False), (1.5, 2.0, 2, False)]
    assert readers.window_rate(_run(recs, 2.5)) == pytest.approx(4 / 2.5)


def test_spread_is_iqr_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_of_device_intervals():
    events = [
        _ev("cpu_op", "aten::step", 0, 100),
        _ev("cpu_op", "aten::item", 54, 42),
        _ev("kernel", "void fps_kernel<8>(float const*)", 10, 20),
        _ev("kernel", "void rpe_attention_kernel<float, 4>(float const*)", 20, 20),  # overlaps
        _ev("kernel", "void sinkhorn_bwd_kernel(float*)", 50, 5),
        _ev("gpu_memcpy", "Memcpy DtoH", 95, 5),
    ]
    s = trace.reduce(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 5 + 5) * 1e-6)
    assert s["kernel_s"] == pytest.approx({"fps": 20e-6, "rpe_attention": 20e-6,
                                           "sinkhorn_bwd": 5e-6})
    gaps = dict(s["idle_gaps"])
    # gaps 0-10 and 40-50 under aten::step alone, 55-95 inside aten::item
    assert gaps["aten::item"] == pytest.approx(40e-6)
    assert gaps["aten::step"] == pytest.approx(20e-6)


def test_kernel_names_map_to_the_port_kernels():
    assert trace.kernel_of("void sinkhorn_kernel<4>(float*)") == "sinkhorn"
    assert trace.kernel_of("void sinkhorn_bwd_kernel(float*)") == "sinkhorn_bwd"
    assert trace.kernel_of("geo_embedding_bwd_reduce") == "geo_embedding_bwd"
    assert trace.kernel_of("void at::native::vectorized_elementwise_kernel<4>") is None


def test_gap_outside_any_operator_goes_to_the_next_one():
    events = [
        _ev("cpu_op", "aten::mm", 0, 10),
        _ev("kernel", "void gemm(float*)", 5, 10),
        _ev("cpu_op", "aten::topk", 30, 10),
        _ev("kernel", "void topk(long*)", 35, 10),
    ]
    gaps = dict(trace.reduce(events)["idle_gaps"])
    assert gaps == pytest.approx({"aten::mm": 5e-6, "between operators, before aten::topk": 20e-6})
