"""The port's span table (``dint_tpu_torch.utils.trace``) and the spans
at its layer boundaries: self time under nesting, the profiler's ranges
in place of the table while a profiler records, a balanced stack after
an exception, and the spans a small encode, plan, upload and decode
record on the CPU."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from dint_tpu_torch.io import collection as t_collection
from dint_tpu_torch.io import synth as t_synth
from dint_tpu_torch.kernels import cuda_ext
from dint_tpu_torch.kernels import decode_local
from dint_tpu_torch.utils import nativebuild, trace


@pytest.fixture
def clock(monkeypatch):
    """The spans' clock, moved by hand: ``clock.now`` in ns."""

    class Clock:
        now = 0

    c = Clock()
    monkeypatch.setattr(trace, "perf_counter_ns", lambda: c.now)
    trace.reset()
    return c


def _row(name):
    return trace.snapshot()[name]


def test_nested_spans_give_counts_totals_and_self_time(clock):
    for _ in range(2):
        with trace.span("outer"):
            clock.now += 10
            with trace.span("inner"):
                clock.now += 3
                with trace.span("leaf"):
                    clock.now += 1
            clock.now += 5
            with trace.span("inner"):
                clock.now += 7
    snap = trace.snapshot()
    assert snap["outer"] == {"count": 2, "total_s": pytest.approx(52e-9),
                             "self_s": pytest.approx(30e-9)}
    assert snap["inner"] == {"count": 4, "total_s": pytest.approx(22e-9),
                             "self_s": pytest.approx(20e-9)}
    assert snap["leaf"] == {"count": 2, "total_s": pytest.approx(2e-9),
                            "self_s": pytest.approx(2e-9)}
    trace.reset()
    assert trace.snapshot() == {}
    with trace.span("outer"):
        clock.now += 4
    assert _row("outer") == {"count": 1, "total_s": pytest.approx(4e-9),
                             "self_s": pytest.approx(4e-9)}


def test_an_exception_leaves_the_stack_balanced(clock):
    with pytest.raises(KeyError, match="boom"):
        with trace.span("outer"):
            clock.now += 2
            with trace.span("failing"):
                clock.now += 3
                raise KeyError("boom")
    assert _row("failing")["count"] == 1
    assert _row("outer")["self_s"] == pytest.approx(2e-9)
    with trace.span("after"):
        clock.now += 6
        with trace.span("child"):
            clock.now += 1
    assert _row("after") == {"count": 1, "total_s": pytest.approx(7e-9),
                             "self_s": pytest.approx(6e-9)}
    assert _row("outer")["count"] == 1


def test_spans_of_other_threads_add_to_the_table_not_to_self_time(clock):
    def work():
        with trace.span("worker"):
            pass

    with trace.span("main"):
        clock.now += 5
        t = threading.Thread(target=work)
        t.start()
        t.join()
    snap = trace.snapshot()
    assert snap["worker"]["count"] == 1
    assert snap["main"]["self_s"] == pytest.approx(5e-9)


def test_under_a_profiler_a_span_is_a_range_and_adds_nothing(tmp_path):
    trace.reset()
    with trace.span("before"):
        pass
    table = trace.snapshot()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("decode.launch"):
            with trace.span("decode.enqueue"):
                torch.ones(4).sum()
    assert trace.snapshot() == table
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    got = sorted(e["name"] for e in events
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith(trace.PREFIX))
    assert got == ["dint.decode.enqueue", "dint.decode.launch"]


def test_outside_a_profiler_no_range_is_opened(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset()
    with trace.span("quiet"):
        pass
    assert _row("quiet")["count"] == 1


def _tiny_stream(root):
    from dint_tpu_torch.tools import encode

    docs, freqs = t_synth.make_collection(40, 4000, seed=5, avg_len=50)
    base = os.path.join(root, "c")
    t_collection.write_freq_collection(base, docs, freqs, 4000)
    stream = os.path.join(root, "c.single_rect_dint.bin")
    encode.encode_collection("single_rect_dint", base + ".docs", stream,
                             cache_dir=root, device="cpu")
    return base, stream, docs


def test_a_cpu_encode_load_and_decode_records_each_site(tmp_path):
    from dint_tpu_torch.dictionary import builder
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import decode

    trace.reset()
    base, stream, docs = _tiny_stream(str(tmp_path))
    arena, meta = stream_mod.load_stream(stream)
    dict_file = os.path.join(str(tmp_path), builder.dict_cache_name(
        base + ".docs", "rectangular"))
    view = decode.load_dictionary("single_rect_dint", dict_file).decode_view()
    dec = decode.StreamDecoder(arena, meta, view, False, "local", None,
                               "cpu")
    before = trace.snapshot().get("decode.launch", {"count": 0})["count"]
    runs = 3
    for s in range(runs):
        out = dec.engine.decode(s)
    snap = trace.snapshot()
    counts = {k: v["count"] for k, v in snap.items()}
    for name in ("build.stats", "build.dictionary", "build.encode",
                 "load.plan", "load.upload"):
        assert counts[name] == 1, name
    # the statistics file and the dictionary file: one span each
    assert counts["build.cache"] == 2
    assert counts["decode.launch"] - before == runs
    assert "decode.enqueue" not in snap  # no library call on the CPU
    for row in snap.values():
        assert 0 <= row["self_s"] <= row["total_s"]
    # the spans leave the result as it was: the exact decode of the lists
    units = dec.engine.gather_units(out, len(dec.layout.starts),
                                    dec.layout.n)
    got = np.concatenate(units)
    want = np.concatenate([np.diff(d.astype(np.int64), prepend=-1) - 1
                           for d in docs])
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_the_fused_launch_is_a_span_whether_it_returns_or_raises():
    trace.reset()
    n0 = torch.tensor([3, 0, 256], dtype=torch.int32)
    salt = torch.ones(1, dtype=torch.int64)
    out = decode_local.decode_classes(n0, None, None, salt)
    assert torch.equal(out, decode_local.decode_classes_plain(
        n0, None, None, salt))
    with pytest.raises(ValueError, match="n_out 7 not in"):
        decode_local.decode_classes(n0, None, None, salt, n_out=7)
    assert _row("decode.launch")["count"] == 2
    assert "decode.enqueue" not in trace.snapshot()


@pytest.mark.parametrize("which", ["native", "cuda"])
def test_a_library_fetch_is_the_span_lib_build(which):
    trace.reset()
    if which == "native":
        src = nativebuild.source_path("dint_stats.cpp")
        assert nativebuild.ensure_so(src, "libdintstats.so")
    else:
        # without nvcc the build raises, as before, and is still timed
        try:
            cuda_ext.build("libdintgather.so")
        except RuntimeError as e:
            assert "nvcc" in str(e)
    row = _row("lib.build")
    assert row["count"] == 1 and row["total_s"] > 0
