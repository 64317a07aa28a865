"""The manifest and the files it names: found by name, within the
contract's characters, and a new configuration, mix and metric picked
up as files and entries alone."""

import json
import os
import shutil

import pytest

from benchmark import harness
from benchmark.manifest import NAME_RE, ROOT, UNIT_RE, Manifest
from benchmark.tests import tiny

MAN = Manifest()
KIND_API = ("setup", "window", "traced_work", "release", "check", "control")


def test_manifest_has_exactly_the_contract_keys():
    assert set(MAN.data) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN.data["run_seconds"] <= 51
    for p in MAN.data["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.startswith("/") and ".." not in p.split("/")


@pytest.mark.parametrize("cell", [c["name"] for c in MAN.data["workloads"]])
def test_each_cell_finds_its_config_mix_and_kind(cell):
    c = MAN.cell(cell)
    cfg = MAN.config(c["config"])
    assert cfg["name"] == c["config"]
    tr = MAN.traffic(c["traffic"])
    kind = MAN.kind(tr["kind"])
    for fn in KIND_API:
        assert callable(getattr(kind, fn))
    assert c["chips"] in (1, 4)
    names = [m["name"] for m in MAN.end_to_end(cell)]
    assert "setup_s" in names and len(names) >= 2
    assert MAN.per_layer(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN.data["per_layer"]])
def test_each_per_layer_metric_has_a_reader_and_its_cells(metric):
    m = next(x for x in MAN.data["per_layer"] if x["name"] == metric)
    assert callable(MAN.metric_reader(metric).read)
    cells = {c["name"] for c in MAN.data["workloads"]}
    assert set(m["workloads"]) <= cells
    moved = next(e for e in MAN.data["end_to_end"] if e["name"] == m["moves"])
    for c in m["workloads"]:
        assert c in moved.get("workloads", [c])


def test_names_units_and_texts_keep_to_the_contract():
    d = MAN.data
    names = []
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in d[sec]:
            assert NAME_RE.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(set(n for n in names)) == len(names)
    for e in d["end_to_end"] + d["per_layer"]:
        assert UNIT_RE.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in d["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for c in d["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME_RE.match(k)
        assert c["file"].startswith(d["paths"][0] + "/")
    for e in d["workloads"]:
        assert NAME_RE.match(e["config"]) and NAME_RE.match(e["traffic"])
    texts = [c["source"] for c in d["configs"]] + [
        e.get("why", "") for sec in ("configs", "workloads")
        for e in d[sec]] + [m["layer"] for m in d["per_layer"]] + d["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert os.path.getsize(MAN.path) <= 64 * 1024


def test_files_under_the_benchmark_are_named_from_name_characters():
    for d, _, files in os.walk(MAN.bench_dir):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_an_added_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    path = tiny.make(str(tmp_path))
    bench = tmp_path / "benchmark"
    man = json.loads(open(path).read())
    cfg = json.loads((bench / "configs" / "gov2s-rect.json").read_text())
    cfg["name"] = "extra-cfg"
    (bench / "configs" / "extra-cfg.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "scan.json").read_text())
    tr["runs_per_call"] = 3
    (bench / "traffic" / "scan-3.json").write_text(json.dumps(tr))
    (bench / "metrics" / "extra_calls.x.py").write_text(
        "def read(r):\n    return float(r.spans.count['decode_chain'])\n")
    man["configs"].append({"name": "extra-cfg", "source": "a test",
                           "file": "benchmark/configs/extra-cfg.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "extra-cfg.scan-3", "config": "extra-cfg",
                             "traffic": "scan-3", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "extra_calls.x", "unit": "calls",
                             "better": "lower", "source": "program_span",
                             "layer": "device", "moves": "decode_ints_per_s",
                             "workloads": ["extra-cfg.scan-3"]})
    man["end_to_end"][0]["workloads"].append("extra-cfg.scan-3")
    with open(path, "w") as f:
        json.dump(man, f)
    m = Manifest(path)
    out = tiny.run(m, "extra-cfg.scan-3", trace=True)
    assert out["correct"]
    assert out["metrics"]["extra_calls.x"]["value"] >= 1
    out = tiny.run(m, "extra-cfg.scan-3")
    assert set(out["metrics"]) == {"decode_ints_per_s", "device_B_per_int",
                                   "setup_s"}


def test_an_unknown_name_is_refused(tmp_path):
    with pytest.raises(KeyError):
        MAN.cell("no-such-cell")
    with pytest.raises(ValueError):
        MAN.traffic("../configs/gov2s-rect")
    with pytest.raises(KeyError):
        MAN.metric_reader("no_such_metric")


def test_the_result_line_keeps_the_contract_keys(tmp_path):
    m = Manifest(tiny.make(str(tmp_path)))
    for trace in (False, True):
        out = tiny.run(m, "gov2s-rect.scan", trace=trace)
        assert list(out)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(out)
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(out["device"])
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        wanted = MAN.per_layer("gov2s-rect.scan") if trace else \
            MAN.end_to_end("gov2s-rect.scan")
        for name, v in out["metrics"].items():
            unit = next(x["unit"] for x in wanted if x["name"] == name)
            assert v["unit"] == unit
