"""The port's last four tools and ``utils/progress`` against the reference.

One small synthetic collection; each package builds its own files from
it (a ``single_packed_dint`` stream, a ``streamvbyte`` zoo stream, the
three dictionary kinds, and a ``single_packed_dint``, an ``ef`` and a
``block_optpfor`` index).  Each tool of both packages runs on each
package's files (the port with ``--device cpu``) and their stats lines
match in every field but times; ``check_encoded_data`` and
``check_index`` end in ``SystemExit`` in both packages on a collection
with one posting changed.  ``compute_contexts_native`` equals the
reference's for single and multi.  Model: tests/test_tools_cli.py.
"""

import json
import os

import numpy as np
import pytest

from dint_tpu.stats import block_stats as j_block_stats
from dint_tpu.stats import native_stats as j_native_stats
from dint_tpu.tools import check_encoded_data as j_ced
from dint_tpu.tools import check_index as j_ci
from dint_tpu.tools import common as j_common
from dint_tpu.tools import create_freq_index as j_cfi
from dint_tpu.tools import dict_perf_test as j_dpt
from dint_tpu.tools import encode as j_encode
from dint_tpu.tools import pair_wise_intersect as j_pwi
from dint_tpu_torch.dictionary import builder
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.stats import block_stats as t_block_stats
from dint_tpu_torch.stats import native_stats as t_native_stats
from dint_tpu_torch.tools import check_encoded_data as t_ced
from dint_tpu_torch.tools import check_index as t_ci
from dint_tpu_torch.tools import common as t_common
from dint_tpu_torch.tools import create_freq_index as t_cfi
from dint_tpu_torch.tools import dict_perf_test as t_dpt
from dint_tpu_torch.tools import encode as t_encode
from dint_tpu_torch.tools import pair_wise_intersect as t_pwi
from dint_tpu_torch.utils import progress as t_progress

PKGS = {
    "ref": {"encode": j_encode, "cfi": j_cfi, "ced": j_ced, "ci": j_ci,
            "pwi": j_pwi, "dpt": j_dpt},
    "port": {"encode": t_encode, "cfi": t_cfi, "ced": t_ced, "ci": t_ci,
             "pwi": t_pwi, "dpt": t_dpt},
}
CPU = {"ref": [], "port": ["--device", "cpu"]}
TIME_KEYS = {"tot_elapsed_time", "ns_x_int", "ints_x_sec", "cold_start_s",
             "avg_us", "q50_us", "ns_per_copy"}
DINT = "single_packed_dint"
ZOO = "streamvbyte"
INDEX_KINDS = (DINT, "ef", "block_optpfor")
DICT_TYPES = {"rectangular": "single_rect_dint", "single": DINT,
              "multi": "multi_packed_dint"}


class _CD:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.old = os.getcwd()
        os.chdir(self.path)

    def __exit__(self, *a):
        os.chdir(self.old)


def _changed_posting(docs):
    """A copy of the doc lists with one docid moved up by one, still
    strictly increasing, in the first list that leaves room for it."""
    out = [d.copy() for d in docs]
    for d in out:
        gaps = np.diff(d.astype(np.int64))
        room = np.flatnonzero(gaps >= 2)
        if room.size:
            d[room[0]] += 1
            return out
    raise AssertionError("no list leaves room for a changed posting")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """{"base", "bad", "queries", "ref": {...}, "port": {...}}: the
    collection, its copy with one posting changed, a query log of
    mostly two-term queries, and each package's files."""
    tmp = tmp_path_factory.mktemp("torch_tools")
    base = str(tmp / "tc")
    num_docs = 9000
    docs, freqs = synth.make_collection(120, num_docs, seed=77, avg_len=50)
    collection.write_freq_collection(base, docs, freqs, num_docs)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, num_docs))
    bad = str(tmp / "bad")
    collection.write_freq_collection(bad, _changed_posting(docs), freqs,
                                     num_docs)
    qf = str(tmp / "queries.txt")
    rng = np.random.default_rng(1)
    with open(qf, "w") as f:
        for i in range(40):
            k = 1 if i % 10 == 9 else 2
            f.write(" ".join(str(int(t)) for t in rng.integers(0, 120, k))
                    + "\n")
        f.write("5 5\n3 200\n")  # a repeated term, a term past the index
    out = {"base": base, "bad": bad, "queries": qf, "docs": docs}
    for pkg, mods in PKGS.items():
        d = str(tmp / pkg)
        os.makedirs(d)
        files = {"dicts": {}}
        with _CD(d):
            for kind, t in DICT_TYPES.items():
                mods["encode"].main([t, base + ".docs", "--out",
                                     f"{t}.bin"])
                files["dicts"][kind] = os.path.join(d, builder.dict_cache_name(
                    base + ".docs", kind))
            files[DINT] = os.path.join(d, f"{DINT}.bin")
            mods["encode"].main([ZOO, base + ".docs", "--out", "zoo.bin"])
            files[ZOO] = os.path.join(d, "zoo.bin")
            for kind in INDEX_KINDS:
                path = os.path.join(d, f"idx.{kind}")
                mods["cfi"].main([kind, base, path])
                files["idx." + kind] = path
        out[pkg] = files
    return out


def _last_record(capsys, err_has=None):
    """The last JSON line on stdout (and, with ``err_has``, a check that
    stderr holds that text)."""
    out, err = capsys.readouterr()
    if err_has is not None:
        assert err_has in err
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def _same_but_times(ref, port, extra=()):
    """The port's record has every field of the reference's, equal but
    for the times, and no other field but ``extra``."""
    for k, v in ref.items():
        if k not in TIME_KEYS:
            assert port[k] == v, (k, port[k], v)
    assert set(port) - set(ref) <= set(extra), set(port) - set(ref)


@pytest.mark.parametrize("files", ["ref", "port"])
@pytest.mark.parametrize("type_name", [DINT, ZOO])
def test_check_encoded_data_matches_reference(workdir, files, type_name,
                                              capsys):
    f = workdir[files]
    argv = [type_name, f[type_name], workdir["base"] + ".docs"]
    if type_name == DINT:
        argv += ["--dict", f["dicts"]["single"]]
    recs = {}
    for pkg in PKGS:
        PKGS[pkg]["ced"].main(argv + CPU[pkg])
        recs[pkg] = _last_record(capsys, "everything's good")
    assert recs["port"]["check"] == "ok"
    _same_but_times(recs["ref"], recs["port"], extra=("device",))


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("type_name", [DINT, ZOO])
def test_check_encoded_data_catches_a_changed_posting(workdir, pkg,
                                                      type_name):
    f = workdir[pkg]
    argv = [type_name, f[type_name], workdir["bad"] + ".docs"]
    if type_name == DINT:
        argv += ["--dict", f["dicts"]["single"]]
    with pytest.raises(SystemExit, match="MISMATCH in list"):
        PKGS[pkg]["ced"].main(argv + CPU[pkg])


@pytest.mark.parametrize("files", ["ref", "port"])
@pytest.mark.parametrize("kind", INDEX_KINDS)
def test_check_index_matches_reference(workdir, files, kind, capsys):
    for pkg in PKGS:
        PKGS[pkg]["ci"].main([kind, workdir[files]["idx." + kind],
                              workdir["base"]])
        assert "it's all good" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("kind", INDEX_KINDS)
def test_check_index_catches_a_changed_posting(workdir, pkg, kind):
    with pytest.raises(SystemExit, match="docid mismatch in list"):
        PKGS[pkg]["ci"].main([kind, workdir[pkg]["idx." + kind],
                              workdir["bad"]])


def _oracle_total(workdir):
    docs = workdir["docs"]
    total = 0
    for line in open(workdir["queries"]):
        q = [int(t) for t in line.split()]
        if len(set(q)) != 2 or not all(0 <= t < len(docs) for t in q):
            continue
        total += np.intersect1d(docs[q[0]], docs[q[1]]).shape[0]
    return total


@pytest.mark.parametrize("files", ["ref", "port"])
@pytest.mark.parametrize("kind,engine", [(DINT, "native"), (DINT, "python"),
                                         ("ef", "python"),
                                         ("block_optpfor", "python"),
                                         (DINT, None), ("ef", None)])
def test_pair_wise_intersect_matches_reference(workdir, files, kind, engine,
                                               capsys):
    argv = [kind, workdir[files]["idx." + kind], "--queries",
            workdir["queries"], "--runs", "2"]
    if engine:
        argv += ["--engine", engine]
    recs = {}
    for pkg in PKGS:
        PKGS[pkg]["pwi"].main(argv + CPU[pkg])
        recs[pkg] = _last_record(capsys)
    _same_but_times(recs["ref"], recs["port"])
    assert int(recs["port"]["pairs"]) > 20
    assert int(recs["port"]["total_results"]) == _oracle_total(workdir)


def test_pair_wise_intersect_engines_agree(workdir):
    argv = [DINT, workdir["port"]["idx." + DINT], "--queries",
            workdir["queries"], "--runs", "2", "--device", "cpu"]
    native = t_pwi.main(argv + ["--engine", "native"])
    python = t_pwi.main(argv + ["--engine", "python"])
    assert native["engine"] == "native" and "engine" not in python
    assert native["total_results"] == python["total_results"]
    assert int(native["total_results"]) > 0


def test_pair_wise_intersect_native_takes_a_dint_kind(workdir):
    with pytest.raises(SystemExit):
        t_pwi.main(["ef", workdir["port"]["idx.ef"], "--queries",
                    workdir["queries"], "--engine", "native"])


def _numpy_checksum(view, gidx):
    """A replay of the numpy engine's checksum: the first word of every
    copied row, summed."""
    from dint_tpu_torch.config import NUM_ENTRIES

    offs = view.offsets[gidx // NUM_ENTRIES, gidx % NUM_ENTRIES]
    return int(view.table[offs.astype(np.int64)].astype(np.int64).sum())


@pytest.mark.parametrize("files", ["ref", "port"])
@pytest.mark.parametrize("kind", sorted(DICT_TYPES))
def test_dict_perf_test_numpy_checksum(workdir, files, kind, capsys):
    argv = [workdir[files]["dicts"][kind], kind, "--copies", "30000",
            "--engine", "numpy"]
    recs = {}
    for pkg in PKGS:
        PKGS[pkg]["dpt"].main(argv)
        recs[pkg] = _last_record(capsys)
    _same_but_times(recs["ref"], recs["port"])
    d = t_dpt.load(workdir[files]["dicts"][kind], kind)
    view = d.decode_view()
    gidx = t_dpt.sample_indices(d, view, kind, 30000,
                                np.random.default_rng(13))
    assert recs["port"]["checksum"] == str(_numpy_checksum(view, gidx))


@pytest.mark.parametrize("kind", sorted(DICT_TYPES))
def test_dict_perf_test_native_is_the_default(workdir, kind, capsys):
    argv = [workdir["port"]["dicts"][kind], kind, "--copies", "20000",
            "--runs", "2"]
    port = t_dpt.main(argv)
    j_dpt.main(argv + ["--engine", "native"])
    ref = _last_record(capsys)
    assert port["engine"] == "native" and float(port["ns_per_copy"]) > 0
    _same_but_times(ref, port)


@pytest.mark.parametrize("kind", sorted(DICT_TYPES))
def test_sample_indices_match_reference(workdir, kind):
    path = workdir["port"]["dicts"][kind]
    d = t_dpt.load(path, kind)
    j_d = {"rectangular": j_dpt.RectangularDictionary,
           "single": j_dpt.PackedDictionary,
           "multi": j_dpt.MultiPackedDictionary}[kind].load(path)
    got = t_dpt.sample_indices(d, d.decode_view(), kind, 5000,
                               np.random.default_rng(13))
    want = j_dpt.sample_indices(j_d, j_d.decode_view(), kind, 5000,
                                np.random.default_rng(13))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_progress_logger(capsys):
    p = t_progress.ProgressLogger(10, "x", every_s=0.0)
    for _ in range(10):
        p.add()
    p.done()
    err = capsys.readouterr().err
    assert "10/10" in err and "100.0%" in err
    p2 = t_progress.ProgressLogger(None, "y", every_s=0.0)
    p2.add(3)
    assert "y: 3" in capsys.readouterr().err


class _Clock:
    """A perf_counter that moves 10 s a call: every add logs."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 10.0
        return self.t


@pytest.mark.parametrize("compute_gaps", [True, False])
def test_gap_stream_logs_progress(workdir, compute_gaps, monkeypatch, capsys):
    import dint_tpu.utils.progress as j_progress

    from dint_tpu.io.collection import BinaryCollection as JColl
    from dint_tpu_torch.io.collection import BinaryCollection as TColl

    path = workdir["base"] + (".docs" if compute_gaps else ".freqs")
    got = {}
    for pkg, mod, coll, stats in (("ref", j_progress, JColl, j_block_stats),
                                  ("port", t_progress, TColl, t_block_stats)):
        monkeypatch.setattr(mod, "time", _Clock())
        lists = list(stats.gap_stream(coll(path), compute_gaps))
        err = capsys.readouterr().err
        got[pkg] = (lists, [ln.split(",")[0] for ln in err.splitlines()
                            if "statistics: lists scanned" in ln])
    assert got["port"][1] and got["port"][1] == got["ref"][1]
    assert len(got["port"][0]) == len(got["ref"][0])
    for a, b in zip(*(got[p][0] for p in ("ref", "port"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("multi", [False, True])
def test_compute_contexts_native_matches_reference(workdir, multi):
    path = workdir["base"] + ".docs"
    gap_lists, total = t_common.gap_lists_of(path)
    j_lists, j_total = j_common.gap_lists_of(path)
    assert total == j_total
    got = t_native_stats.compute_contexts_native(gap_lists, total, multi)
    want = j_native_stats.compute_contexts_native(j_lists, total, multi)
    assert got is not None and want is not None
    assert len(got) == len(want) == (len(want) if multi else 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.freqs, w.freqs)
        np.testing.assert_array_equal(g.data, w.data)
    assert sum(g.lengths.shape[0] for g in got) > 0


def test_compute_contexts_native_without_library(monkeypatch):
    monkeypatch.setattr(t_native_stats, "get_lib", lambda: None)
    assert t_native_stats.compute_contexts_native([], 0, True) is None


@pytest.mark.parametrize("type_name", [DINT, "multi_packed_dint"])
def test_decode_index_host_equals_the_list_oracle(tmp_path, type_name):
    """``decode_index_host`` (check_index's batched decode: native DINT
    units, batched interpolative blocks) gives every list's docids and
    freqs as ``list_docids_host`` / ``list_freqs_host`` do, an empty
    list and lists of exactly one block included."""
    from dint_tpu_torch.index import dint_index

    docs, freqs = synth.make_collection(40, 5000, seed=3, avg_len=400)
    docs[5], freqs[5] = docs[5][:0], freqs[5][:0]
    docs[6], freqs[6] = docs[6][:256], freqs[6][:256]
    base = str(tmp_path / "c")
    collection.write_freq_collection(base, docs, freqs, 5000)
    with _CD(str(tmp_path)):
        t_cfi.main([type_name, base, "idx"])
    idx = dint_index.DintIndex.load(str(tmp_path / "idx"))
    got_d, got_f, offs = dint_index.decode_index_host(idx)
    assert offs[-1] == sum(len(d) for d in docs)
    for i, d in enumerate(docs):
        if not len(d):
            assert offs[i + 1] == offs[i]
            continue
        np.testing.assert_array_equal(got_d[offs[i]:offs[i + 1]],
                                      dint_index.list_docids_host(idx, i))
        np.testing.assert_array_equal(got_d[offs[i]:offs[i + 1]], d)
        np.testing.assert_array_equal(got_f[offs[i]:offs[i + 1]],
                                      dint_index.list_freqs_host(idx, i))
        np.testing.assert_array_equal(got_f[offs[i]:offs[i + 1]], freqs[i])
