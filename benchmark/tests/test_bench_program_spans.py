"""The per-layer metrics read from the program's own span table
(``dint_tpu_torch.utils.trace``): reported by a traced run, absent from an
untraced one, and left out, not raised, where the program keeps no span
table."""

import json
import subprocess
import sys

import pytest

from benchmark import profiling
from benchmark.manifest import ROOT, Manifest
from benchmark.tests import tiny

MAN = Manifest()
SPAN_METRICS = ("stats_s", "dictionary_s", "cache_write_s", "encode_s",
                "plan_s", "upload_s", "lib_build_s", "launch_host_us.scan")


def test_the_program_span_metrics_are_in_the_manifest():
    got = {m["name"]: m for m in MAN.per_layer("gov2s-rect.scan")}
    for name in SPAN_METRICS:
        assert got[name]["source"] == "program_span"


def test_a_traced_run_reports_every_span_metric(tmp_path):
    """In a process of its own, as the benchmark runs a cell: the
    libraries are fetched once there, so ``lib.build`` ran too."""
    code = ("import json; from benchmark.tests import tiny; "
            "from benchmark.manifest import Manifest; "
            f"m = Manifest(tiny.make({str(tmp_path)!r})); "
            "print(json.dumps(tiny.run(m, 'gov2s-rect.scan', trace=True)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["value"] >= 0, name
    assert got["launch_host_us.scan"]["value"] > 0
    assert got["launch_host_us.scan"]["unit"] == "us"
    # the program's build spans lie inside the benchmark's, and so do its
    # load spans
    build = sum(got[n]["value"] for n in ("stats_s", "dictionary_s",
                                          "cache_write_s", "encode_s"))
    assert build <= got["build_s"]["value"]
    assert got["plan_s"]["value"] + got["upload_s"]["value"] <= \
        got["load_s"]["value"]


def test_an_untraced_run_reports_the_end_to_end_metrics_alone(tmp_path):
    from dint_tpu_torch.utils import trace

    trace.reset()  # the workers of a test run run several cells
    m = Manifest(tiny.make(str(tmp_path)))
    out = tiny.run(m, "gov2s-rect.scan")
    assert set(out["metrics"]) == {"decode_ints_per_s", "device_B_per_int",
                                   "setup_s"}


@pytest.mark.parametrize("table", ["none in the program", "empty"])
@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_span_that_never_ran_reads_none(name, table, monkeypatch):
    from dint_tpu_torch import utils
    from dint_tpu_torch.utils import trace

    if table == "empty":
        trace.reset()
    else:  # as in a program before the span table: the import fails
        monkeypatch.delattr(utils, "trace")
        monkeypatch.setitem(sys.modules, "dint_tpu_torch.utils.trace", None)
    assert MAN.metric_reader(name).read(None) is None


def test_an_idle_gap_is_named_by_the_innermost_program_range():
    events = [
        {"cat": "user_annotation", "name": "bench.decode_chain", "ts": 0,
         "dur": 100},
        {"cat": "user_annotation", "name": "dint.decode.launch", "ts": 10,
         "dur": 30},
        {"cat": "user_annotation", "name": "dint.decode.enqueue", "ts": 20,
         "dur": 15},
        {"cat": "kernel", "name": "k", "ts": 0, "dur": 25},
        {"cat": "kernel", "name": "k", "ts": 50, "dur": 5},
    ]
    out = profiling.reduce_events(events, 100e-6)
    assert out["idle_gaps"][0][0] == "decode_chain/dint.decode.enqueue"
