"""The whole slice: the port's bench and kernel ablation on the CPU.

``tools/bench.main`` runs every leg of the reference's ``bench.py`` (the
gather and ladder engines for both DINT types, the spot checks, the
store probe) at a tiny size with ``device="cpu"``; the legs' records
must carry the reference's ``decode_stream`` values for the same
streams (``num_integers``, ``plan_bytes``, ``check``), exactly.
``tools/kernel_ablate`` must find every variant exact before it times
it.
"""

import json
import os

import pytest
import torch

from dint_tpu.tools import decode as j_decode
from dint_tpu_torch.kernels import decode_local as t_dl
from dint_tpu_torch.tools import bench as t_bench
from dint_tpu_torch.tools import kernel_ablate as t_ablate

SIZE = ["--num-lists", "150", "--num-docs", "20000", "--avg-len", "80",
        "--seed", "5"]
REFERENCE_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "bench_rate",
    "gather_engine_ints_per_sec", "gather_image_B_per_int",
    "gather_effective_GBps", "gather_cold_start_s", "store_GBps_probe",
    "store_wall_ints_per_sec", "ladder_engine_ints_per_sec",
    "ladder_image_B_per_int", "ladder_cold_start_s",
    "ladder_effective_GBps", "multi_packed_ints_per_sec",
    "multi_packed_vs_baseline", "multi_packed_gather_ints_per_sec",
)


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("torch_bench"))
    out = t_bench.main(["--device", "cpu", "--cache-dir", cache,
                        "--runs", "2", *SIZE])
    return cache, out


def test_record_has_the_reference_field_names(bench_run):
    _, out = bench_run
    assert set(out) == set(REFERENCE_FIELDS) | {"device", "legs"}
    assert out["device"] == "cpu"
    assert out["metric"] == "vroom_decode_ints_per_sec_per_chip"
    assert out["unit"] == "ints/s"
    assert out["value"] == max(out["gather_engine_ints_per_sec"],
                               out["ladder_engine_ints_per_sec"])
    assert out["vs_baseline"] == out["value"] / 1.5e9
    assert out["multi_packed_ints_per_sec"] >= \
        out["multi_packed_gather_ints_per_sec"]
    # the probe's GB/s is rounded to one decimal, which a loaded CPU can
    # round to 0.0; the wall derived from the unrounded rate cannot be 0
    assert out["store_GBps_probe"] >= 0 and out["store_wall_ints_per_sec"] > 0
    assert "scale_rate" not in out and "scale_vs_baseline" not in out


def test_stdout_is_the_one_json_line(tmp_path, capsys, bench_run):
    cache, out = bench_run
    t_bench.main(["--device", "cpu", "--cache-dir", cache, "--runs", "1",
                  *SIZE])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == set(REFERENCE_FIELDS) | {"device"}


@pytest.mark.parametrize("leg,type_name,engine", [
    ("gather", "single_rect_dint", "local"),
    ("ladder", "single_rect_dint", "ladder"),
    ("multi_gather", "multi_packed_dint", "local"),
    ("multi_ladder", "multi_packed_dint", "ladder"),
])
def test_leg_matches_reference_decode_stream(bench_run, leg, type_name,
                                             engine):
    cache, out = bench_run
    trec = out["legs"][leg]
    kind = {"single_rect_dint": "rectangular",
            "multi_packed_dint": "multi_packed"}[type_name]
    stream = os.path.join(cache, f"bench.{type_name}.v2.bin")
    dict_file = os.path.join(
        cache, f"dict.bench_collection.docs.{kind}.DSF-65536-16")
    assert trec["filename"] == stream
    # the reference plans its own image: no cache file of the port's run
    for f in os.listdir(cache):
        if ".plan." in f or ".image." in f:
            os.remove(os.path.join(cache, f))
    jrec = j_decode.decode_stream(
        type_name, stream, dict_file, runs=1,
        check_collection=os.path.join(cache, "bench_collection.docs"),
        engine=engine)
    assert jrec["check"] == "ok"
    for k in ("num_sequences", "num_integers", "type", "engine",
              "plan_bytes"):
        assert trec[k] == jrec[k], k
    if engine == "ladder":
        assert trec["check"] == "ok"
        key = ("ladder_engine_ints_per_sec" if leg == "ladder"
               else "multi_packed_ints_per_sec")
        assert out[key] >= float(trec["ints_x_sec"])
    else:
        assert "check" not in trec  # the gather legs are spot-checked
        assert trec["rows"] == jrec["rows"]


def test_image_sizes_in_the_record(bench_run):
    _, out = bench_run
    g, lad = out["legs"]["gather"], out["legs"]["ladder"]
    n = float(g["num_integers"])
    assert out["gather_image_B_per_int"] == round(int(g["plan_bytes"]) / n, 3)
    assert out["ladder_image_B_per_int"] == round(
        int(lad["plan_bytes"]) / n, 3)


def test_a_failing_leg_raises(tmp_path, monkeypatch, bench_run):
    """Nothing is swallowed: a ladder leg that cannot run stops the
    bench."""
    cache, _ = bench_run
    from dint_tpu_torch.tools import decode as t_decode

    def boom(*a, **kw):
        raise RuntimeError("no ladder today")

    monkeypatch.setattr(t_decode, "LadderStreamDecoder", boom)
    with pytest.raises(RuntimeError, match="no ladder today"):
        t_bench.main(["--device", "cpu", "--cache-dir", cache, "--runs", "1",
                      *SIZE])


def test_spot_check_catches_a_wrong_list(bench_run, monkeypatch):
    cache, _ = bench_run
    from dint_tpu_torch.tools import decode as t_decode

    real = t_decode.StreamDecoder.gather_lists

    def corrupt(self):
        lists = real(self)
        for a in lists:
            if a.size:
                a[0] += 1
        return lists

    monkeypatch.setattr(t_decode.StreamDecoder, "gather_lists", corrupt)
    stream = os.path.join(cache, "bench.single_rect_dint.v2.bin")
    dict_file = os.path.join(
        cache, "dict.bench_collection.docs.rectangular.DSF-65536-16")
    with pytest.raises(AssertionError, match="list"):
        t_bench.spot_check(stream, dict_file,
                           os.path.join(cache, "bench_collection"),
                           device="cpu")


def test_default_device_raises_without_cuda(bench_run, monkeypatch):
    cache, _ = bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bench.main(["--cache-dir", cache, "--runs", "1", *SIZE])


@pytest.mark.parametrize("type_name", ["single_rect_dint",
                                       "multi_packed_dint"])
def test_kernel_ablate_checks_then_times_every_variant(bench_run, type_name,
                                                       capsys):
    cache, out = bench_run
    kind = {"single_rect_dint": "rectangular",
            "multi_packed_dint": "multi_packed"}[type_name]
    stream = os.path.join(cache, f"bench.{type_name}.v2.bin")
    dict_file = os.path.join(
        cache, f"dict.bench_collection.docs.{kind}.DSF-65536-16")
    rec = t_ablate.main([type_name, stream, "--dict", dict_file,
                         "--runs", "2", "--device", "cpu"])
    assert set(rec["variants"]) == set(t_ablate.VARIANTS)
    assert rec["ints"] == int(out["legs"]["gather"]["num_integers"])
    assert rec["padded_rows"] % 256 == 0 and rec["rows"] <= rec["padded_rows"]
    for v in rec["variants"].values():
        assert v["ms_per_run"] > 0 and v["ints_per_s"] > 0
    text = capsys.readouterr().out
    assert text.count("EXACT") == len(t_ablate.VARIANTS)
    assert json.loads(text.strip().splitlines()[-1])["device"] == "cpu"


def test_kernel_ablate_refuses_an_inexact_variant(bench_run, monkeypatch):
    cache, _ = bench_run
    stream = os.path.join(cache, "bench.single_rect_dint.v2.bin")
    dict_file = os.path.join(
        cache, "dict.bench_collection.docs.rectangular.DSF-65536-16")
    plan = t_ablate.plan_of_stream("single_rect_dint", stream, dict_file)
    real = t_dl.decode_gather_rows

    def off_by_one(vidx, table, n, salt):
        out = real(vidx, table, n, salt)
        out[0, 0] += 1
        return out

    from dint_tpu_torch.kernels import decode_pallas as t_dp

    monkeypatch.setattr(t_dp, "decode_gather_rows", off_by_one)
    with pytest.raises(RuntimeError, match="v_pallas: MISMATCH"):
        t_ablate.run(plan, runs=1, variants=("v_pallas",), device="cpu")
    with pytest.raises(ValueError, match="unknown variants"):
        t_ablate.run(plan, runs=1, variants=("v_bogus",), device="cpu")


def test_chained_runs_feeds_each_salt_from_the_output():
    seen = []

    def fn(salt):
        seen.append(int(salt.item()))
        return torch.tensor([[3, 9]], dtype=torch.int32)

    dt = t_ablate.chained_runs(fn, 3, torch.device("cpu"))
    assert dt > 0
    # warm-up from salt 1, then salt 1 and (3 & 1) + k for k = 1, 2
    assert seen == [1, 1, 2, 3]
