"""The port's host query engines against the reference's.

``wand``, ``maxscore`` and ``ranked_and`` walk the lazy cursors and add
in the same order on the host as ``dint_tpu.query.ranked``, so their
scores are compared bit for bit; the lazy boolean forms return exact
docid sets; the decode counters of the caches agree.  ``tools.queries``'
host engine (``run_op``, ``--engine host``) is driven for every op.
Index, wand data and query log are files made once and loaded by both
packages.
"""

import json

import numpy as np
import pytest

from dint_tpu.query import boolean as j_bool
from dint_tpu.query import lazy_decode as j_lazy
from dint_tpu.query import ranked as j_ranked
from dint_tpu.query.term_decode import TermDecoder as JTermDecoder
from dint_tpu.tools import queries as j_queries
from dint_tpu_torch.query import boolean as t_bool
from dint_tpu_torch.query import lazy_decode as t_lazy
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.query.term_decode import TermDecoder
from dint_tpu_torch.tools import queries as t_queries
from tests.test_torch_lazy_decode import (EMPTY, NUM_LISTS, SINGLE,
                                          build_files, load_both)

K = 10
HOST_OPS = ("and", "and_freq", "or", "or_freq", "wand", "maxscore",
            "ranked_and", "ranked_or")


def make_queries(n=24, seed=9):
    rng = np.random.default_rng(seed)
    qs = [[int(t) for t in rng.choice(NUM_LISTS, size=int(rng.integers(2, 5)),
                                      replace=False)] for _ in range(n)]
    return qs + [[0], [EMPTY], [EMPTY, 3], [SINGLE, 5], [5, 5, 9]]


@pytest.fixture(scope="module", params=["uniform", "skew"])
def built(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"thq_{request.param}"))
    idx_path, wand_path, docs, freqs = build_files(root, request.param)
    ti, ji = load_both(idx_path)
    queries = make_queries()
    qfile = f"{root}/q.txt"
    with open(qfile, "w") as f:
        f.write("".join(" ".join(map(str, q)) + "\n" for q in queries))
        f.write(f"0 {NUM_LISTS + 59}\n")  # names an unknown term: dropped
    return {"ti": ti, "ji": ji, "docs": docs, "freqs": freqs,
            "twd": t_ranked.WandData.load(wand_path),
            "jwd": j_ranked.WandData.load(wand_path), "queries": queries,
            "files": (idx_path, wand_path, qfile)}


def counters(cache):
    return (cache.docs_blocks_decoded, cache.freqs_blocks_decoded,
            cache.postings_scored)


def test_topk_queue_matches_reference():
    rng = np.random.default_rng(0)
    tq, jq = t_ranked.TopKQueue(5), j_ranked.TopKQueue(5)
    for x in rng.random(40):
        assert tq.would_enter(float(x)) == jq.would_enter(float(x))
        assert tq.insert(float(x)) == jq.insert(float(x))
    np.testing.assert_array_equal(tq.topk(), jq.topk())
    assert tq.topk().dtype == np.float32 and tq.topk().shape == (5,)


@pytest.mark.parametrize("op", ["wand", "maxscore", "ranked_and"])
def test_ranked_host_ops_bit_for_bit(built, op):
    ti, ji, twd, jwd = built["ti"], built["ji"], built["twd"], built["jwd"]
    tdec, jdec = TermDecoder(ti, device="cpu"), JTermDecoder(ji)
    assert tdec.lazy_cache is tdec.lazy_cache  # memoised
    assert isinstance(tdec.lazy_cache, t_lazy.BlockCache)
    oracle = TermDecoder(ti, device="cpu")
    for q in built["queries"]:
        tdec._lazy_cache = t_lazy.BlockCache(ti)
        jdec._lazy_cache = j_lazy.BlockCache(ji)
        got = getattr(t_ranked, op)(ti, tdec, twd, q, K)
        want = getattr(j_ranked, op)(ji, jdec, jwd, q, K)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"{op} {q}")
        assert counters(tdec.lazy_cache) == counters(jdec.lazy_cache), q
        if op != "ranked_and":  # the same top-k as the exhaustive scorer
            full = t_ranked.ranked_or(ti, oracle, twd, q, K)
            assert got.shape == full.shape
            np.testing.assert_allclose(got, full, rtol=2e-4, atol=1e-5)


def test_wand_and_maxscore_skip_blocks(built):
    """On a query of a long and a short list the cursors decode fewer
    docid blocks than the lists hold."""
    ti, twd = built["ti"], built["twd"]
    by_len = np.argsort(ti.list_n, kind="stable")
    q = [int(by_len[-1]), int(by_len[-2]), int(by_len[len(by_len) // 2])]
    total = sum(ti.list_blocks(t)[1] - ti.list_blocks(t)[0] for t in q)
    dec = TermDecoder(ti, device="cpu")
    for fn in (t_ranked.wand, t_ranked.maxscore):
        dec._lazy_cache = t_lazy.BlockCache(ti)
        fn(ti, dec, twd, q, K)
        c = dec.lazy_cache
        assert 0 < c.freqs_blocks_decoded <= c.docs_blocks_decoded <= total
        assert 0 < c.postings_scored < sum(int(ti.list_n[t]) for t in q)


def test_ranked_and_without_a_lazy_cache_takes_the_decoded_lists(built):
    """A decoder with no block cache (the reference's other index
    families) goes through the pre-decoded lists; same scores."""
    ti, twd = built["ti"], built["twd"]
    dec = TermDecoder(ti, device="cpu")

    class Plain:
        decode_docids = dec.decode_docids
        decode_freqs = dec.decode_freqs

    for q in built["queries"][:10]:
        a = t_ranked.ranked_and(ti, dec, twd, q, K)
        b = t_ranked.ranked_and(ti, Plain(), twd, q, K)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            t_ranked.wand(ti, Plain(), twd, q, K),
            t_ranked.ranked_or(ti, dec, twd, q, K))


def test_lazy_boolean_forms_are_exact(built):
    ti, ji, docs, freqs = (built["ti"], built["ji"], built["docs"],
                           built["freqs"])
    for q in built["queries"]:
        tc, jc = t_lazy.BlockCache(ti), j_lazy.BlockCache(ji)
        terms = sorted(set(q))
        want_and = docs[terms[0]]
        for t in terms[1:]:
            want_and = np.intersect1d(want_and, docs[t])
        got_and = t_bool.and_query_lazy(tc, q)
        np.testing.assert_array_equal(got_and, want_and)
        np.testing.assert_array_equal(got_and, j_bool.and_query_lazy(jc, q))
        got_or = t_bool.or_query_lazy(tc, q)
        np.testing.assert_array_equal(
            got_or, np.unique(np.concatenate([docs[t] for t in terms])))
        np.testing.assert_array_equal(got_or, j_bool.or_query_lazy(jc, q))
        mf = t_bool.matched_freqs_lazy(tc, q, got_and)
        jmf = j_bool.matched_freqs_lazy(jc, q, got_and)
        assert mf.keys() == jmf.keys() == set(terms)
        for t in terms:
            np.testing.assert_array_equal(mf[t], jmf[t])
            pos = np.searchsorted(docs[t], got_and)
            np.testing.assert_array_equal(mf[t], freqs[t][pos])
        assert counters(tc) == counters(jc)
    assert t_bool.and_query_lazy(t_lazy.BlockCache(ti), []).shape == (0,)
    assert t_bool.or_query_lazy(t_lazy.BlockCache(ti), []).shape == (0,)


def test_lazy_and_decodes_few_blocks_of_the_long_list(built):
    ti = built["ti"]
    by_len = np.argsort(ti.list_n, kind="stable")
    long_t = int(by_len[-1])
    short_t = next(int(t) for t in by_len if 2 <= ti.list_n[t] <= 40)
    cache = t_lazy.BlockCache(ti)
    t_bool.and_query_lazy(cache, [long_t, short_t])
    nb_long = ti.list_blocks(long_t)[1] - ti.list_blocks(long_t)[0]
    assert cache.docs_blocks_decoded <= 1 + int(ti.list_n[short_t]) < nb_long


@pytest.mark.parametrize("op,with_freqs", [("and", False), ("and", True),
                                           ("or", False), ("or", True)])
def test_run_boolean_batch_matches_reference(built, op, with_freqs):
    ti, ji = built["ti"], built["ji"]
    # the warm freq touch indexes each term's list at the matches, which
    # an empty list beside a match cannot take (in the reference too)
    queries = [q for q in built["queries"] if EMPTY not in q]
    got, t_s = t_bool.run_boolean_batch(TermDecoder(ti, device="cpu"),
                                        queries, op, with_freqs)
    want, _ = j_bool.run_boolean_batch(JTermDecoder(ji), queries, op,
                                       with_freqs)
    assert len(got) == len(t_s) == len(queries)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", HOST_OPS)
def test_run_op_host_engine(built, op):
    """Every host op runs from fresh caches; the lazy ops leave the same
    block and posting totals as the reference's run_op."""
    ti, ji, twd, jwd = built["ti"], built["ji"], built["twd"], built["jwd"]
    tdec, jdec = TermDecoder(ti, device="cpu"), JTermDecoder(ji)
    stats = t_queries.run_op(ti, tdec, twd, built["queries"], op, 1, K)
    assert set(stats) == {"avg", "q50", "q90", "q95"}
    assert all(v > 0 for v in stats.values())
    j_queries.run_op(ji, jdec, jwd, built["queries"], op, 1, K)
    assert tdec._lazy_totals == jdec._lazy_totals
    if op == "ranked_or":
        assert tdec._lazy_totals is None
    else:
        assert tdec._lazy_totals["docs_blocks"] > 0
    with pytest.raises(ValueError, match="unsupported"):
        t_queries.run_op(ti, tdec, twd, built["queries"], "nope", 1, K)


def test_queries_cli_host_engine_every_op(built, capsys):
    idx, wand, qfile = built["files"]
    recs = t_queries.main(["single_packed_dint", ":".join(HOST_OPS), idx,
                           wand, "--queries", qfile, "--runs", "1",
                           "--engine", "host", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == recs
    assert [r["type"] for r in recs] == list(HOST_OPS)
    for r in recs:
        assert r["engine"] == "host" and r["device"] == "cpu"
        assert r["queries"] == str(len(built["queries"]))
        assert {"avg", "q50", "q90", "q95"} <= set(r)
        assert ("docs_blocks" in r) == (r["type"] != "ranked_or")
    by = {r["type"]: r for r in recs}
    # the _freq forms decode freq blocks, the plain forms none
    assert by["and"]["freqs_blocks"] == by["or"]["freqs_blocks"] == "0"
    assert int(by["or_freq"]["freqs_blocks"]) > 0
    assert int(by["wand"]["postings_scored"]) > 0


def test_queries_cli_native_engine_names_its_item(built):
    """``--engine native``, ported since, answers: its counts equal the
    host engine's and the reference's native engine's over the same
    files."""
    idx, wand, qfile = built["files"]
    ops = ("and", "or", "wand")
    argv = ["single_packed_dint", ":".join(ops), idx, wand, "--queries",
            qfile, "--runs", "1", "--device", "cpu"]
    recs = t_queries.main(argv + ["--engine", "native"])
    assert [r["type"] for r in recs] == list(ops)
    from dint_tpu.query.native_host import NativeQueryEngine as JNative

    jeng = JNative(built["ji"], built["jwd"])
    ti, tdec = built["ti"], TermDecoder(built["ti"], device="cpu")
    for r in recs:
        assert r["engine"] == "native" and r["device"] == "host"
        assert r["queries"] == str(len(built["queries"]))
        _, cnt, _ = jeng.run(r["type"], built["queries"], runs=2, k=K)
        assert r["total_results"] == str(int(cnt.sum()))
        if r["type"] == "wand":
            want = sum(t_ranked.ranked_or(ti, tdec, built["twd"], q, K).size
                       for q in built["queries"])
        else:
            fn = t_bool.and_query if r["type"] == "and" else t_bool.or_query
            docs = tdec.decode_docids(range(NUM_LISTS))
            want = sum(fn(docs, t_bool.dedup_terms(q)).size
                       for q in built["queries"])
        assert r["total_results"] == str(want), r["type"]
