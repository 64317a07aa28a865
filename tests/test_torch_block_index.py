"""The port's block-codec index family against the reference's.

The eleven ``block_<codec>`` kinds (``block_mixed`` included) must save
the reference's files byte for byte, each package loading the other's;
the block profiler, the decode-time predictor and the access-weighted
mixed build must equal the reference's; ``ZooBlockCache`` must decode the
same blocks with the same counters and its cursors walk the same
postings.  ``tools.queries --engine device`` must take the reference's
dispatch (``dint_tpu/tools/queries.py:139-145, :162-167``): the fused
store (K4) with Block-Max pruning for a block kind, the row path
unpruned for an EF kind, with the reference's batch shapes, top-k
scores (the store's, against the reference store's and the host oracle,
rtol 2e-4, atol 1e-5) and counts; ``blocks_kept`` is compared wherever
the survival masks agree (ROADMAP.md section 4).  Models:
tests/test_block_codecs_and_index.py, tests/test_lazy_queries.py:230-290.
"""

import json
import os

import numpy as np
import pytest

from dint_tpu.index import block_index as j_bi
from dint_tpu.index import freq_index as j_fi
from dint_tpu.index import mixed_block as j_mb
from dint_tpu.query import bmw_device as j_bmwd
from dint_tpu.query import device_batch as j_db
from dint_tpu.query import device_serve as j_ds
from dint_tpu.query import lazy_decode as j_lazy
from dint_tpu.query import ranked as j_ranked
from dint_tpu.tools import queries as j_queries
from dint_tpu.utils import block_profiler as j_prof
from dint_tpu.utils import dec_time_prediction as j_dtp
from dint_tpu_torch.index import block_index as t_bi
from dint_tpu_torch.index import freq_index as t_fi
from dint_tpu_torch.index import mixed_block as t_mb
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.query import bmw_device as t_bmwd
from dint_tpu_torch.query import device_batch as t_db
from dint_tpu_torch.query import device_serve as t_ds
from dint_tpu_torch.query import lazy_decode as t_lazy
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.tools import common as t_common
from dint_tpu_torch.tools import create_freq_index as t_cfi
from dint_tpu_torch.tools import queries as t_queries
from dint_tpu_torch.utils import block_profiler as t_prof
from dint_tpu_torch.utils import dec_time_prediction as t_dtp

NUM_LISTS = 24
NUM_DOCS = 20_000
SINGLE = 3
K = 10


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    """(root, basename, docs, freqs, wand data, queries): 24 lists over
    20,000 docs (full and partial blocks, one single-posting list) with
    its .sizes file, wand data with the block-max sidecar and 20
    queries."""
    root = str(tmp_path_factory.mktemp("torch_block"))
    base = os.path.join(root, "c")
    docs, freqs = synth.make_collection(NUM_LISTS, NUM_DOCS, seed=11,
                                        avg_len=400)
    docs[SINGLE], freqs[SINGLE] = docs[SINGLE][:1], freqs[SINGLE][:1]
    collection.write_freq_collection(base, docs, freqs, NUM_DOCS)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, NUM_DOCS))
    wd = t_ranked.build_wand_data(base)
    rng = np.random.default_rng(5)
    queries = [[int(t) for t in rng.choice(NUM_LISTS,
                                           size=int(rng.integers(2, 5)),
                                           replace=False)]
               for _ in range(16)]
    queries += [[0], [SINGLE, 5], [5, 5, 9], [1, 2, 3, 4, 6, 7, 8, 10, 11]]
    return root, base, docs, freqs, wd, queries


@pytest.fixture(scope="module")
def block_files(coll):
    """{kind: (port file, reference file)} of every block kind, each
    built by its own package."""
    root, base = coll[0], coll[1]
    out = {}
    for kind in t_common.BLOCK_KINDS:
        codec = t_common.block_codec_of(kind)
        tp, jp = (os.path.join(root, f"{w}_{kind}.npz") for w in "tj")
        if codec == "mixed":
            t_mb.build_mixed_index(base).save(tp)
            j_mb.build_mixed_index(base).save(jp)
        else:
            t_bi.build_block_index(base, codec).save(tp)
            j_bi.build_block_index(base, codec).save(jp)
        out[kind] = (tp, jp)
    return out


@pytest.mark.parametrize("kind", t_common.BLOCK_KINDS)
def test_block_index_files_byte_equal_and_cross_load(coll, block_files, kind):
    base = coll[1]
    tp, jp = block_files[kind]
    a, b = np.load(tp), np.load(jp)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    ti, ji = t_bi.BlockIndex.load(jp), j_bi.BlockIndex.load(tp)
    t_bi.verify_block_index(ti, base)
    j_bi.verify_block_index(ji, base)
    assert ti.size_stats() == ji.size_stats()
    np.testing.assert_array_equal(ti.docs_end, ji.docs_end)


@pytest.mark.parametrize("kind", ["block_optpfor", "block_mixed"])
def test_create_freq_index_cli_block_kinds(coll, block_files, tmp_path,
                                           capsys, kind):
    out = str(tmp_path / "idx.npz")
    idx = t_cfi.main([kind, coll[1], out, "--check"])
    (line,) = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert json.loads(line) == {"type": kind, **idx.size_stats()}
    assert (np.load(out)["arena"].tobytes()
            == np.load(block_files[kind][1])["arena"].tobytes())


def test_create_freq_index_accepts_every_reference_type():
    from dint_tpu.tools import create_freq_index as j_cfi

    assert t_cfi.ALL_TYPES == j_cfi.ALL_TYPES
    assert t_queries.ALL_TYPES == j_cfi.ALL_TYPES


@pytest.mark.parametrize("kind", ["block_optpfor", "block_mixed"])
def test_get_and_write_blocks_match_reference(block_files, kind):
    tp, _ = block_files[kind]
    ti, ji = t_bi.BlockIndex.load(tp), j_bi.BlockIndex.load(tp)
    per_list = []
    for i in range(NUM_LISTS):
        tb, jb = t_bi.get_blocks(ti, i), j_bi.get_blocks(ji, i)
        assert tb == jb
        per_list.append([tb[0]] + tb[1:][::-1])  # any order but the first
    t2, j2 = t_bi.write_blocks(ti, per_list), j_bi.write_blocks(ji, per_list)
    for f in ("list_n", "block_ptr", "block_max", "docs_end", "block_end",
              "arena"):
        np.testing.assert_array_equal(getattr(t2, f), getattr(j2, f))
        np.testing.assert_array_equal(getattr(t2, f), getattr(ti, f))


@pytest.mark.parametrize("kind", ["block_optpfor", "block_qmx",
                                  "block_interpolative", "block_mixed"])
def test_zoo_block_cache_and_cursors_match_reference(block_files, kind):
    tp, _ = block_files[kind]
    ti, ji = t_bi.BlockIndex.load(tp), j_bi.BlockIndex.load(tp)
    tc, jc = t_lazy.ZooBlockCache(ti), j_lazy.ZooBlockCache(ji)
    rng = np.random.default_rng(len(kind))
    pairs = [(t, int(b)) for t in range(NUM_LISTS)
             for b in rng.choice(np.arange(*ti.list_blocks(t)),
                                 size=min(2, ti.list_blocks(t)[1]
                                          - ti.list_blocks(t)[0]),
                                 replace=False)]
    tc.docs_blocks_batch(pairs)
    jc.docs_blocks_batch(pairs)
    tc.freqs_blocks_batch(pairs[::2])
    jc.freqs_blocks_batch(pairs[::2])
    for t, b in pairs:
        np.testing.assert_array_equal(tc.docs_block(t, b), jc.docs_block(t, b))
        np.testing.assert_array_equal(tc.freqs_block(t, b),
                                      jc.freqs_block(t, b))
    for term in range(NUM_LISTS):
        tcur, jcur = tc.make_cursor(term), jc.make_cursor(term)
        for _ in range(10):
            lb = int(rng.integers(0, NUM_DOCS + 1))
            tcur.next_geq(lb)
            jcur.next_geq(lb)
            tcur.next()
            jcur.next()
            assert (tcur.docid(), tcur.position()) == (jcur.docid(),
                                                       jcur.position())
            if tcur.position() < tcur.size:
                assert tcur.freq() == jcur.freq()
    assert (tc.docs_blocks_decoded, tc.freqs_blocks_decoded) == (
        jc.docs_blocks_decoded, jc.freqs_blocks_decoded)
    tc.reset_counters()
    assert tc.docs_blocks_decoded == tc.freqs_blocks_decoded == 0


def test_block_term_decoder(coll, block_files, monkeypatch):
    import torch

    _, _, docs, freqs, _, _ = coll
    ti = t_bi.BlockIndex.load(block_files["block_varintgb"][0])
    dec = t_bi.BlockTermDecoder(ti, device="cpu")
    assert dec.device.type == "cpu"
    terms = list(range(NUM_LISTS))
    got_d, got_f = dec.decode_docids(terms), dec.decode_freqs(terms)
    for t in terms:
        np.testing.assert_array_equal(got_d[t], docs[t])
        np.testing.assert_array_equal(got_f[t], freqs[t])
    assert isinstance(dec.lazy_cache, t_lazy.ZooBlockCache)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_bi.BlockTermDecoder(ti)


def test_profiler_and_access_weighted_mixed_build(coll, block_files,
                                                  tmp_path):
    """Profiled block accesses and a fixed decode-time predictor drive
    the mixed build to the reference's bytes; the profiler's counts and
    its TSV equal the reference's."""
    base = coll[1]
    tp, _ = block_files["block_optpfor"]
    counts = {}
    for pkg, bi, prof in (("t", t_bi, t_prof), ("j", j_bi, j_prof)):
        idx = bi.BlockIndex.load(tp)
        prof.reset()
        prof.enable(True)
        try:
            for t in range(0, NUM_LISTS, 2):
                p0, p1 = idx.list_blocks(t)
                for b in range(p0, p1):
                    idx.block_docs(b, t)
                    if (b - p0) % 2 == 0:
                        idx.block_freqs(b, t)
        finally:
            prof.enable(False)
        path = str(tmp_path / f"{pkg}.tsv")
        prof.dump(path)
        counts[pkg] = prof.load(path)
    assert counts["t"].keys() == counts["j"].keys() and counts["t"]
    for t in counts["t"]:
        np.testing.assert_array_equal(counts["t"][t], counts["j"][t])
    weights = {c: np.linspace(0.5, 4.0, len(t_dtp.FEATURES)) * (i + 1)
               for i, c in enumerate(t_mb.CANDIDATES)}
    ti = t_mb.build_mixed_index(base, t_dtp.Predictor(weights),
                                counts["t"], lam=0.05)
    ji = j_mb.build_mixed_index(base, j_dtp.Predictor(weights),
                                counts["j"], lam=0.05)
    for f in ("list_n", "block_ptr", "block_max", "docs_end", "block_end",
              "arena"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f))
    assert ti.arena.tobytes() != np.load(
        block_files["block_mixed"][0])["arena"].tobytes()
    t_bi.verify_block_index(ti, base)


def test_dec_time_prediction_matches_reference(tmp_path):
    from dint_tpu_torch.codecs import blocks as t_blocks

    rng = np.random.default_rng(2)
    vals = rng.integers(0, 300, 256).astype(np.uint32)
    body = t_blocks.CODECS["optpfor"][0](vals, t_blocks.UNKNOWN)
    assert t_dtp.pfor_features("optpfor", body, 256) == j_dtp.pfor_features(
        "optpfor", body, 256) != (0, 0)
    assert t_dtp.pfor_features("vbyte", body, 256) == (0, 0)
    f = t_dtp.feature_vector(vals, len(body), 5, 3)
    np.testing.assert_array_equal(f, j_dtp.feature_vector(vals, len(body),
                                                          5, 3))
    samples = {"optpfor": [(rng.random(len(t_dtp.FEATURES)),
                            float(rng.random() * 100)) for _ in range(30)]}
    tp, jp = t_dtp.train(samples), j_dtp.train(samples)
    np.testing.assert_array_equal(tp.weights["optpfor"],
                                  jp.weights["optpfor"])
    path = str(tmp_path / "pred.json")
    tp.save(path)
    back = j_dtp.Predictor.load(path)
    assert back.predict("optpfor", f) == tp.predict("optpfor", f)
    assert tp.predict("qmx", f) == 0.0


# ---------------------------------------------------------------------------
# tools.queries' device engine: the reference's dispatch gates
# ---------------------------------------------------------------------------


def spy_fused(monkeypatch):
    """Calls of the fused serving path, recorded; it still runs."""
    calls = []
    real = t_queries.run_op_device_fused

    def spy(*a, **kw):
        calls.append(a[4])
        return real(*a, **kw)

    monkeypatch.setattr(t_queries, "run_op_device_fused", spy)
    return calls


def oracle(index, decoder, wd, q):
    return t_ranked.ranked_or(index, decoder, wd, q, K)


@pytest.fixture(scope="module")
def served(coll, block_files):
    """Port and reference (index, decoder) of block_optpfor."""
    wd = coll[4]
    tp, _ = block_files["block_optpfor"]
    ti, ji = t_bi.BlockIndex.load(tp), j_bi.BlockIndex.load(tp)
    return (ti, t_bi.BlockTermDecoder(ti, device="cpu"), ji,
            j_bi.BlockTermDecoder(ji), wd)


def test_device_engine_block_kind_against_reference(coll, served,
                                                    monkeypatch):
    queries = coll[5]
    ti, tdec, ji, jdec, wd = served
    calls = spy_fused(monkeypatch)
    for op in ("ranked_or", "wand", "maxscore", "and", "or"):
        _, tshape, textra = t_queries.run_op_device(ti, tdec, wd, queries,
                                                    op, 1, K)
        _, jshape, jextra = j_queries.run_op_device(ji, jdec, wd, queries,
                                                    op, 1, K)
        assert tshape == jshape, op
        if op in ("and", "or"):
            want = j_db.boolean_count_batch(jdec, queries, op)
            assert textra["total_results"] == str(int(want.sum()))
            continue
        assert textra["engine_variant"] == jextra["engine_variant"]
        assert textra["blocks_total"] == jextra["blocks_total"]
        if op == "ranked_or":
            assert textra["blocks_kept"] == jextra["blocks_kept"]
            continue
        assert "device_queries" in textra  # pruned by the survival pass
        multi = [q for q in queries if len(set(q)) > 1]
        tk, _, _ = t_bmwd.prune_blocks_device(
            t_lazy.ZooBlockCache(ti), ti, wd, multi, K, device="cpu")
        jk, _, _ = j_bmwd.prune_blocks_device(
            j_lazy.ZooBlockCache(ji), ji, wd, multi, K)
        same = all(np.array_equal(tk[i][t], jk[i][t])
                   for i in range(len(multi)) if tk[i] is not None
                   for t in tk[i])
        kept, total = int(textra["blocks_kept"]), int(textra["blocks_total"])
        assert kept < total
        if same:
            assert textra["blocks_kept"] == jextra["blocks_kept"]
    assert calls == ["ranked_or", "wand", "maxscore"]
    # the store's top-k: the reference store's, and the host oracle's
    ts = t_ds.DeviceServingStore(ti, tdec, wd)
    js = j_ds.DeviceServingStore(ji, jdec, wd)
    for prune in (False, True):
        t_s, _, _ = ts.ranked_topk(queries, k=K, prune=prune,
                                   lazy_cache=t_lazy.ZooBlockCache(ti))
        j_s, _, _ = js.ranked_topk(queries, k=K, prune=prune,
                                   lazy_cache=j_lazy.ZooBlockCache(ji))
        for i, q in enumerate(queries):
            want = oracle(ti, tdec, wd, q)
            assert t_s[i].shape == j_s[i].shape == want.shape
            np.testing.assert_allclose(t_s[i], j_s[i], rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(t_s[i], want, rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ef_served(coll):
    root, base, _, _, wd, _ = coll
    path = os.path.join(root, "ef.npz")
    t_fi.build_freq_index(base, "ef").save(path)
    ti, ji = t_fi.FreqIndexEF.load(path), j_fi.FreqIndexEF.load(path)
    return (ti, t_fi.EFTermDecoder(ti, device="cpu"), ji,
            j_fi.EFTermDecoder(ji, device_ef=False), wd)


def test_device_engine_ef_kind_takes_the_row_path(coll, ef_served,
                                                  monkeypatch):
    """No ``list_blocks``: ranked ops skip the fused store (so K4); no
    ``docs_blocks_batch``: wand and maxscore are not pruned."""
    queries = coll[5]
    ti, tdec, ji, jdec, wd = ef_served
    assert not hasattr(ti, "list_blocks")
    assert not hasattr(tdec.lazy_cache, "docs_blocks_batch")
    calls = spy_fused(monkeypatch)
    for op in ("ranked_or", "wand", "maxscore", "and", "or"):
        _, tshape, textra = t_queries.run_op_device(ti, tdec, wd, queries,
                                                    op, 1, K)
        _, jshape, jextra = j_queries.run_op_device(ji, jdec, wd, queries,
                                                    op, 1, K)
        assert tshape == jshape, op
        assert "blocks_kept" not in textra and jextra == {}
        if op in ("and", "or"):
            want = j_db.boolean_count_batch(jdec, queries, op)
            assert textra["total_results"] == str(int(want.sum()))
        else:
            assert textra == {}
    assert calls == []
    got = t_db.ranked_or_batch(ti, tdec, wd, queries, k=K)
    ref = j_db.ranked_or_batch(ji, jdec, wd, queries, k=K)
    for i, q in enumerate(queries):
        np.testing.assert_array_equal(got[i], ref[i])
        np.testing.assert_allclose(got[i], oracle(ti, tdec, wd, q),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["block_optpfor", "ef"])
@pytest.mark.parametrize("engine", ["device", "host"])
def test_queries_cli_block_and_ef_kinds(coll, block_files, ef_served,
                                        tmp_path, kind, engine):
    root, _, _, _, wd, queries = coll
    idx = (block_files[kind][0] if kind.startswith("block_")
           else os.path.join(root, "ef.npz"))
    wand = str(tmp_path / "w")
    wd.save(wand)
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(" ".join(map(str, q)) + "\n" for q in queries))
    ops = ("ranked_or", "wand", "maxscore", "and", "or")
    recs = t_queries.main([kind, ":".join(ops), idx, wand + ".npz",
                           "--queries", str(qfile), "--runs", "1",
                           "--engine", engine, "--device", "cpu"])
    assert [r["type"] for r in recs] == list(ops)
    for r in recs:
        assert r["index"] == kind and r["engine"] == engine
        assert r["queries"] == str(len(queries)) and float(r["avg"]) > 0
    if engine == "device":
        fused = [r.get("engine_variant") == "fused-store" for r in recs[:3]]
        assert fused == [kind != "ef"] * 3
        ti, tdec = t_queries.load_index(kind, idx, "cpu")
        for r in recs[3:]:
            want = t_db.boolean_count_batch(tdec, queries, r["type"])
            assert r["total_results"] == str(int(want.sum()))
