"""The trace arithmetic: busy time as the union of device intervals,
idle gaps named by the benchmark span and host operation open when they
begin, the top device operations."""

import pytest

from benchmark import profiling


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    events = [
        _ev("user_annotation", "bench.serve", 0, 65),
        _ev("cpu_op", "aten::sort", 10, 20),
        _ev("user_annotation", "bench.prune", 65, 95),
        _ev("cpu_op", "aten::copy_", 68, 40),
        _ev("kernel", "k1", 5, 20),
        _ev("kernel", "k2", 15, 20),     # overlaps k1: counted once
        _ev("gpu_memcpy", "Memcpy HtoD", 60, 10),
        _ev("kernel", "k1", 125, 5),
    ]
    out = profiling.reduce_events(events, 200e-6)
    assert out["busy_s"] == pytest.approx((35 - 5 + 10 + 5) * 1e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(25e-6)]
    assert out["idle_gaps"][0] == ["prune/aten::copy_", pytest.approx(55e-6)]
    assert out["idle_gaps"][1] == ["serve", pytest.approx(25e-6)]


def test_a_trace_without_device_work_reads_no_busy_time():
    out = profiling.reduce_events([_ev("cpu_op", "aten::add", 0, 5)], 1e-3)
    assert out["busy_s"] is None and out["device_ops"] == []
