"""The port's fused serving store, K4's plain version and the
sort-merge engine against the reference.

K4's plain version must equal the reference's portable block copy
(``_gather_fn(NB, G, False)``) bit for bit, pad rows included; the
device_batch functions equal ``_kernels()`` (counts exactly, scores bit
for bit: the port repeats the reference's stable sort, scan and shifted
adds in the same order); the store's layout, batch metadata and ranked
top-k scores equal the reference store's, and lie within the
reference's own tolerance (rtol 2e-4, atol 1e-5,
tests/test_device_serve.py:87) of the host oracle ``ranked_or``.
Docids are compared wherever the score is not tied within the row's
top k + 1.  With Block-Max pruning (``prune=True`` and a lazy cache)
the top-k stays what it was; the survival masks are the port's own
(tests/test_torch_bmw.py says where they differ from the reference's),
so the pruned block counts are held to the reference's only where the
masks agree.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.index import dint_index as j_di
from dint_tpu.query import device_batch as j_db
from dint_tpu.query import device_serve as j_ds
from dint_tpu.query import lazy_decode as j_lazy
from dint_tpu.query import ranked as j_ranked
from dint_tpu.query.term_decode import TermDecoder as JTermDecoder
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.query import device_batch as t_db
from dint_tpu_torch.query import bmw_device as t_bmwd
from dint_tpu_torch.query import device_serve as t_ds
from dint_tpu_torch.query import lazy_decode as t_lazy
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.query.term_decode import TermDecoder
from dint_tpu_torch.tools import queries as t_queries
from tests.test_torch_index import write_serve_collection

K = 10
PAD = int(t_ds.PAD_DOC)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------


def k4_inputs(NB, G, seed):
    """A store with a PAD last row and a batch with pad-row ids and qw of
    0, negative and large values."""
    rng = np.random.default_rng(seed)
    dstore = rng.integers(0, 1 << 31, (NB, 256)).astype(np.int32)
    dstore[-1] = PAD
    wstore = rng.random((NB, 256)).astype(np.float32)
    wstore[-1] = 0.0
    blk = rng.integers(0, NB, G).astype(np.int32)
    blk[::3] = NB - 1
    qw = (rng.standard_normal(G) * 7).astype(np.float32)
    qw[::4] = 0.0
    qw[1::5] = -np.abs(qw[1::5])
    return dstore, wstore, blk, qw


@pytest.mark.parametrize("G", [1, 7, 64, 257])
def test_k4_plain_matches_reference_portable_gather(G):
    NB = 37
    dstore, wstore, blk, qw = k4_inputs(NB, G, G)
    jd, js = j_ds._gather_fn(NB, G, False)(
        jnp.asarray(blk), jnp.asarray(qw),
        jnp.asarray(dstore.reshape(NB, 1, 256)),
        jnp.asarray(wstore.reshape(NB, 1, 256)))
    td, ts = t_ds.block_copy(_t(blk), _t(qw), _t(dstore), _t(wstore))
    assert td.dtype == torch.int32 and ts.dtype == torch.float32
    assert td.shape == ts.shape == (G, 256)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).reshape(G, 256))
    # bit for bit, -0.0 and all
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).reshape(G, 256).view(np.int32))
    assert (td.numpy()[blk == NB - 1] == PAD).all()


def test_k4_plain_keeps_subnormal_products():
    """The plain version (like the CUDA kernel, whose result chip_smoke.py
    holds to it on the card) keeps IEEE subnormal products.  XLA's CPU
    backend flushes them to zero, so on those lanes the reference gives
    0 and the port the exact numpy product; elsewhere they agree bit for
    bit."""
    NB, G = 9, 16
    dstore, wstore, blk, qw = k4_inputs(NB, G, 3)
    qw[2::3] = np.float32(1e-40)
    _, js = j_ds._gather_fn(NB, G, False)(
        jnp.asarray(blk), jnp.asarray(qw),
        jnp.asarray(dstore.reshape(NB, 1, 256)),
        jnp.asarray(wstore.reshape(NB, 1, 256)))
    js = np.asarray(js).reshape(G, 256)
    _, ts = t_ds.block_copy(_t(blk), _t(qw), _t(dstore), _t(wstore))
    want = wstore[blk] * qw[:, None]
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  want.view(np.int32))
    sub = (want != 0) & (np.abs(want) < np.finfo(np.float32).tiny)
    assert sub.any()
    assert (js[sub] == 0).all()
    np.testing.assert_array_equal(js[~sub].view(np.int32),
                                  want[~sub].view(np.int32))


def test_k4_out_of_range_ids_read_the_pad_row():
    """Any block id outside [0, NB) names the PAD row NB-1, on the CPU
    as in the kernel (chip_smoke.py's edge batches hold the two equal on
    the card)."""
    NB, G = 11, 12
    dstore, wstore, blk, qw = k4_inputs(NB, G, 4)
    bad = np.array([-1, NB, NB + 5, 2**31 - 1, -2**31], np.int32)
    blk[1:1 + bad.shape[0]] = bad
    td, ts = t_ds.block_copy(_t(blk), _t(qw), _t(dstore), _t(wstore))
    ids = np.where((blk >= 0) & (blk < NB), blk, NB - 1)
    np.testing.assert_array_equal(td.numpy(), dstore[ids])
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  (wstore[ids] * qw[:, None]).view(np.int32))
    assert (td.numpy()[1:1 + bad.shape[0]] == PAD).all()


def test_k4_wrapper_checks_its_inputs():
    dstore, wstore, blk, qw = k4_inputs(5, 8, 1)
    d, w, b, q = _t(dstore), _t(wstore), _t(blk), _t(qw)
    for bad in ((b.long(), q, d, w), (b, q.double(), d, w), (b, q[:3], d, w),
                (b, q, d[:, :128], w), (b, q, d, w[:4]),
                (b[None], q, d, w)):
        with pytest.raises(ValueError):
            t_ds.block_copy(*bad)
    t_ds.reset_launch_counts()
    t_ds.block_copy(b, q, d, w)
    # the CPU path is the plain version: no kernel launch is counted
    assert t_ds.launch_counts() == {"K4_block_copy": 0}
    e = t_ds.block_copy(b[:0], q[:0], d, w)
    assert e[0].shape == (0, 256)


# ---------------------------------------------------------------------------
# The sort-merge engine
# ---------------------------------------------------------------------------


def ranked_rows(seed, Q=6, P=512, terms=4):
    """(d, s): per query the concatenated postings of up to ``terms``
    lists (a docid at most once per list), PAD-padded."""
    rng = np.random.default_rng(seed)
    d = np.full((Q, P), PAD, np.int32)
    s = np.zeros((Q, P), np.float32)
    for q in range(Q):
        parts = [np.sort(rng.choice(300, int(rng.integers(0, 90)),
                                    replace=False))
                 for _ in range(int(rng.integers(1, terms + 1)))]
        row = np.concatenate(parts).astype(np.int32)
        d[q, :row.shape[0]] = row
        s[q, :row.shape[0]] = rng.random(row.shape[0]).astype(np.float32) * 9
    return d, s


def assert_topk_equal(top_t, doc_t, top_j, doc_j, cand_scores=None):
    """Scores bit for bit; docids wherever the score is untied within
    the row's top k + 1 (``cand_scores`` holds each row's k+1 best)."""
    np.testing.assert_array_equal(top_t.view(np.int32), top_j.view(np.int32))
    for r in range(top_t.shape[0]):
        ref = cand_scores[r] if cand_scores is not None else top_j[r]
        for j in range(top_t.shape[1]):
            if np.isfinite(top_t[r, j]) and (ref == top_t[r, j]).sum() == 1:
                assert doc_t[r, j] == doc_j[r, j], (r, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranked_union_topk_matches_reference(seed):
    d, s = ranked_rows(seed)
    j_rut, _, _ = j_db._kernels()
    jt, jd = (np.asarray(x) for x in j_rut(jnp.asarray(d), jnp.asarray(s),
                                            k=K + 1))
    tt, td = t_db.ranked_union_topk(_t(d), _t(s), K)
    assert_topk_equal(tt.numpy(), td.numpy(), jt[:, :K], jd[:, :K], jt)


@pytest.mark.parametrize("seed", [0, 3])
def test_boolean_counts_and_members_match_reference(seed):
    d, _ = ranked_rows(seed, terms=5)
    nterms = np.asarray([2, 1, 3, 4, 5, 2], np.int32)
    _, j_bc, j_am = j_db._kernels()
    ja, jo = j_bc(jnp.asarray(d), jnp.asarray(nterms))
    ta, to = t_db.boolean_counts(_t(d), _t(nterms))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jds, jm = j_am(jnp.asarray(d), jnp.asarray(nterms))
    tds, tm = t_db.and_members(_t(d), _t(nterms))
    np.testing.assert_array_equal(tds.numpy(), np.asarray(jds))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_host_assembly_matches_reference():
    lengths = [0, 5, 31, 32, 33, 127, 513, 4097, 70000]
    assert t_db.bucket_queries(lengths) == j_db.bucket_queries(lengths)
    rows = [np.arange(n, dtype=np.int32) for n in (0, 3, 40)]
    np.testing.assert_array_equal(t_db.pad_batch(rows, t_db.PAD_DOC, np.int32),
                                  j_db.pad_batch(rows, j_db.PAD_DOC, np.int32))
    with pytest.raises(ValueError, match="2\\^31-1"):
        t_db._check_docid_range({3: np.asarray([1, 2**31 - 1], np.uint32)})


def test_topk_rows_hierarchical_at_2_19_lanes():
    rng = np.random.default_rng(2)
    P = 1 << 19
    cand = rng.standard_normal((2, P)).astype(np.float32)
    cand[0, ::7] = -np.inf
    d = rng.integers(0, 1 << 30, size=(2, P)).astype(np.int32)
    top, docs = t_ds._topk_rows(_t(cand), _t(d), K)
    want = np.sort(cand, axis=1)[:, ::-1][:, :K]
    np.testing.assert_array_equal(top.numpy(), want)
    jt, jd = j_ds._topk_rows(jnp.asarray(cand), jnp.asarray(d), K)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(docs.numpy(), np.asarray(jd))
    for r in range(2):
        np.testing.assert_array_equal(
            docs.numpy()[r], d[r][np.argsort(-cand[r], kind="stable")][:K])


@pytest.mark.parametrize("tmax", [1, 2, 3, 5])
def test_bucket_topk_matches_reference(tmax):
    d, s = ranked_rows(tmax, terms=tmax)
    if tmax == 1:  # single-term rows hold unique docids
        for r in range(d.shape[0]):
            u = np.unique(d[r][d[r] != PAD])
            d[r] = PAD
            d[r, :u.shape[0]] = u
    P = d.shape[1]
    jt, jd = (np.asarray(x) for x in j_ds._bucket_topk(
        jnp.asarray(d), jnp.asarray(s), P, K + 1, tmax, jnp.int32(0)))
    tt, td = t_ds._bucket_topk(_t(d), _t(s), P, K, tmax)
    assert_topk_equal(tt.numpy(), td.numpy(), jt[:, :K], jd[:, :K], jt)
    rt, _ = t_ds._bucket_topk(_t(d), _t(s), P, K, tmax, shift=77)
    np.testing.assert_array_equal(rt.numpy(), tt.numpy())


# ---------------------------------------------------------------------------
# The store on the serving fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["uniform", "skew"])
def built(request, tmp_path_factory):
    """(port index, reference index, wand data, queries, root) for the
    fixture collection, ``single`` kind."""
    shape = request.param
    root = str(tmp_path_factory.mktemp(f"tds_{shape}"))
    base = os.path.join(root, "c")
    write_serve_collection(base, shape)
    ti = t_di.build_index(base, kind="single", cache_dir=root + "/t")
    ji = j_di.build_index(base, kind="single", cache_dir=root + "/j")
    wd = t_ranked.build_wand_data(base)
    rng = np.random.default_rng(3)
    queries = [
        [int(t) for t in rng.integers(0, 40, size=int(rng.integers(1, 5)))]
        for _ in range(30)
    ]
    queries += [[7], [7, 3], [8, 8, 8], [8, 7], [0, 1, 2, 3, 4, 5]]
    return ti, ji, wd, queries, root


@pytest.fixture(scope="module")
def stores(built):
    ti, ji, wd, queries, _ = built
    tdec = TermDecoder(ti, device="cpu")
    jdec = JTermDecoder(ji)
    return (t_ds.DeviceServingStore(ti, tdec, wd),
            j_ds.DeviceServingStore(ji, jdec, wd), tdec)


def test_store_layout_matches_reference(stores):
    ts, js, _ = stores
    assert ts.NB == js.NB and ts.store_bytes == js.store_bytes
    np.testing.assert_array_equal(ts.blk_off, js.blk_off)
    np.testing.assert_array_equal(ts.nb, js.nb)
    np.testing.assert_array_equal(ts._dstore.numpy(),
                                  np.asarray(js._dstore).reshape(-1, 256))
    np.testing.assert_array_equal(ts._wstore.numpy(),
                                  np.asarray(js._wstore).reshape(-1, 256))
    assert (ts._dstore[-1] == PAD).all()
    assert ts.topk_dtw.keys() == js.topk_dtw.keys()
    for t in ts.topk_dtw:
        for a, b in zip(ts.topk_dtw[t], js.topk_dtw[t]):
            np.testing.assert_array_equal(a, b)
    assert set(ts.build_timings) == {"decode_s", "term_loop_s", "upload_s"}


def unpruned_stats(ref):
    """The reference's batch stats, which the port reports under the same
    names; with nothing pruned the kept and total block counts agree."""
    assert ref["blocks_kept"] == ref["blocks_total"]
    return dict(ref)


def test_batch_metadata_matches_reference(stores, built):
    ts, js, _ = stores
    queries = built[3]
    tb, tsg, tst = ts._batch_metadata(queries, K, prune=False)
    jb, jsg, jst = js._batch_metadata(queries, K, prune=False)
    assert tsg == jsg and tb.keys() == jb.keys()
    assert tst == unpruned_stats(jst)
    for P in tb:
        ti_, tblk, tqw, ttm = tb[P]
        ji_, jblk, jqw, jtm = jb[P]
        assert ti_ == ji_ and ttm == jtm
        np.testing.assert_array_equal(tblk, jblk)
        np.testing.assert_array_equal(tqw, jqw)
    for wl in ([(0, 1.5), (3, 0.25)], [(7, 2.0)], [(1, 1.0)]):
        assert ts.tau_from_tables(wl, K) == js.tau_from_tables(wl, K)


def test_ranked_topk_matches_reference_store_and_oracle(stores, built):
    ts, js, tdec = stores
    ti, _, wd, queries, _ = built
    t_s, t_d, t_st = ts.ranked_topk(queries, k=K, prune=False)
    j_s, j_d, j_st = js.ranked_topk(queries, k=K, prune=False)
    j_s1, _, _ = js.ranked_topk(queries, k=K + 1, prune=False)
    assert t_st == unpruned_stats(j_st)
    for i, q in enumerate(queries):
        assert t_s[i].dtype == np.float32
        np.testing.assert_array_equal(t_s[i], j_s[i], err_msg=f"{i} {q}")
        for j in range(t_s[i].shape[0]):
            if (j_s1[i] == t_s[i][j]).sum() == 1:
                assert t_d[i][j] == j_d[i][j], (i, q, j)
        want = t_ranked.ranked_or(ti, tdec, wd, q, K)
        assert t_s[i].shape == want.shape
        np.testing.assert_allclose(t_s[i], want, rtol=2e-4, atol=1e-5,
                                   err_msg=f"query {i} {q}")
        np.testing.assert_array_equal(
            want, j_ranked.ranked_or(built[1], JTermDecoder(built[1]), wd, q,
                                     K))


def test_ranked_or_batch_matches_store(stores, built):
    ts, _, tdec = stores
    ti, ji, wd, queries, _ = built
    old = t_db.ranked_or_batch(ti, tdec, wd, queries, k=K)
    ref = j_db.ranked_or_batch(ji, JTermDecoder(ji), wd, queries, k=K)
    new_s, _, _ = ts.ranked_topk(queries, k=K, prune=False)
    for i in range(len(queries)):
        np.testing.assert_array_equal(old[i], ref[i])
        np.testing.assert_allclose(new_s[i], old[i], rtol=1e-6, atol=1e-7)
    for op in ("and", "or"):
        np.testing.assert_array_equal(
            t_db.boolean_count_batch(tdec, queries, op),
            j_db.boolean_count_batch(JTermDecoder(ji), queries, op))
    for a, b in zip(t_db.and_results_batch(tdec, queries),
                    j_db.and_results_batch(JTermDecoder(ji), queries)):
        np.testing.assert_array_equal(a, b)


def prunes(built, kept, total) -> bool:
    """Whether the counts show pruning as this fixture allows it: the
    uniform collection loses blocks; on the skewed one every block of
    these short lists can reach the top k, and none may be lost."""
    return kept < total if "uniform" in built[4] else kept <= total


def test_pruned_ranked_topk_raises(stores, built):
    """``prune=True`` with a lazy cache no longer raises: it serves the
    same top-k from fewer blocks.  Without a lazy cache, or without the
    block-max sidecar, there is nothing to prune with."""
    ts, _, tdec = stores
    ti, _, wd, queries, _ = built
    a, ad, ast = ts.ranked_topk(queries, k=K, prune=True,
                                lazy_cache=tdec.lazy_cache)
    b, bd, bst = ts.ranked_topk(queries, k=K, prune=False)
    c, _, cst = ts.ranked_topk(queries, k=K, prune=True)
    assert ast["blocks_total"] == bst["blocks_total"] == cst["blocks_kept"]
    assert prunes(built, ast["blocks_kept"], ast["blocks_total"])
    assert "device_queries" in ast and "device_queries" not in cst
    for i in range(len(queries)):
        # the survivors hold every top-k doc with its complete score, and
        # the bucket sums add in docid order whatever else was dropped
        np.testing.assert_array_equal(a[i], b[i], err_msg=str(queries[i]))
        np.testing.assert_array_equal(c[i], b[i])
        if a[i].size:  # docids wherever the score is untied
            keep = np.r_[a[i][1:] != a[i][:-1], True] & np.r_[
                True, a[i][1:] != a[i][:-1]]
            np.testing.assert_array_equal(ad[i][keep], bd[i][keep])
    bare = t_ds.DeviceServingStore(
        ti, tdec, t_ranked.WandData(wd.norm_lens, wd.max_term_weight),
        terms=[0, 1])
    _, _, st = bare.ranked_topk([[0, 1]], k=K, prune=True,
                                lazy_cache=tdec.lazy_cache)
    assert st["blocks_kept"] == st["blocks_total"]


def test_pruned_batch_metadata_against_reference(stores, built):
    """Hints, fallbacks and event width equal the reference's; the kept
    block ids are the reference's wherever the survival masks agree, and
    the port's masks are the float64 bound's (tests/test_torch_bmw.py)."""
    ts, js, tdec = stores
    ti, ji, wd, queries, _ = built
    tb, tsg, tst = ts._batch_metadata(queries, K, prune=True,
                                      lazy_cache=t_lazy.BlockCache(ti))
    jb, jsg, jst = js._batch_metadata(queries, K, prune=True,
                                      lazy_cache=j_lazy.BlockCache(ji))
    assert tsg == jsg
    for key in ("blocks_total", "single_term_queries", "device_queries",
                "host_fallback_queries", "event_width"):
        assert tst[key] == jst[key], key
    assert prunes(built, tst["blocks_kept"], tst["blocks_total"])
    # per query: the port's masks against the reference's
    multi = [qi for qi in range(len(queries)) if qi not in tsg]
    hints = [ts.tau_from_tables(t_ranked._query_weights(ti, queries[qi]), K)
             for qi in multi]
    tk, ttau, _ = t_bmwd.prune_blocks_device(
        t_lazy.BlockCache(ti), ti, wd, [queries[qi] for qi in multi], K,
        taus_hint=hints, device="cpu")
    from dint_tpu.query import bmw_device as j_bmwd
    jk, jtau, _ = j_bmwd.prune_blocks_device(
        j_lazy.BlockCache(ji), ji, wd, [queries[qi] for qi in multi], K,
        taus_hint=hints)
    np.testing.assert_array_equal(ttau, jtau)
    same = all(np.array_equal(tk[i][t], jk[i][t])
               for i in range(len(multi)) if tk[i] is not None
               for t in tk[i])
    if same:
        assert tst == jst and tb.keys() == jb.keys()
        for P in tb:
            np.testing.assert_array_equal(tb[P][1], jb[P][1])
            np.testing.assert_array_equal(tb[P][2], jb[P][2])
    kept = sum(int(m.sum()) for k in tk if k is not None for m in k.values())
    assert kept == tst["blocks_kept"]


def test_pruned_topk_matches_reference_store_and_oracle(stores, built):
    ts, js, tdec = stores
    ti, ji, wd, queries, _ = built
    t_s, t_d, t_st = ts.ranked_topk(queries, k=K, prune=True,
                                    lazy_cache=t_lazy.BlockCache(ti))
    j_s, _, j_st = js.ranked_topk(queries, k=K, prune=True,
                                  lazy_cache=j_lazy.BlockCache(ji))
    assert t_st["upload_bytes"] == 8 * sum(
        b[1].shape[0] for b in ts._batch_metadata(
            queries, K, prune=True, lazy_cache=tdec.lazy_cache)[0].values())
    for i, q in enumerate(queries):
        assert t_s[i].shape == j_s[i].shape, (i, q)
        np.testing.assert_allclose(t_s[i], j_s[i], rtol=2e-4, atol=1e-5)
        want = t_ranked.ranked_or(ti, tdec, wd, q, K)
        assert t_s[i].shape == want.shape
        np.testing.assert_allclose(t_s[i], want, rtol=2e-4, atol=1e-5)
        assert t_d[i].shape == t_s[i].shape


# ---------------------------------------------------------------------------
# tools.queries on the CPU
# ---------------------------------------------------------------------------


def _cli_files(built, tmp_path):
    ti, _, wd, queries, _ = built
    idx = str(tmp_path / "idx.npz")
    ti.save(idx)
    wand = str(tmp_path / "w")
    wd.save(wand)
    qfile = tmp_path / "q.txt"
    qfile.write_text("".join(" ".join(map(str, q)) + "\n" for q in queries)
                     + "0 99\n")  # a query naming an unknown term is dropped
    return idx, wand + ".npz", str(qfile)


def test_queries_cli_device_engine_on_cpu(built, tmp_path, capsys):
    import json

    idx, wand, qfile = _cli_files(built, tmp_path)
    recs = t_queries.main(["single_packed_dint", "ranked_or:and:or", idx,
                           wand, "--queries", qfile, "--runs", "2",
                           "--engine", "device", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["type"] for r in lines] == ["ranked_or", "and", "or"]
    assert lines == recs
    n = len(built[3])
    for r in lines:
        assert r["queries"] == str(n) and r["device"] == "cpu"
        assert {"avg", "q50", "q90", "q95", "batch_shape"} <= set(r)
    ranked = lines[0]
    assert {"store_bytes", "store_build_s", "metadata_upload_bytes",
            "single_term_queries"} <= set(ranked)
    ji = built[1]
    queries = built[3]
    for r, op in zip(lines[1:], ("and", "or")):
        want = j_db.boolean_count_batch(JTermDecoder(ji), queries, op)
        assert r["total_results"] == str(int(want.sum()))


@pytest.mark.parametrize("args,match", [
    (["--engine", "host"], None),
    (["--engine", "native"], None),
], ids=["args0-item 1", "args1-item 5"])
def test_queries_cli_unported_engines_raise(built, tmp_path, args, match):
    """The host and native engines, ported since, both answer; the native
    engine's ranked_or returns min(k, matching docs) a query, as the host
    oracle does."""
    idx, wand, qfile = _cli_files(built, tmp_path)
    argv = ["single_packed_dint", "ranked_or", idx, wand, "--queries", qfile,
            "--device", "cpu", "--runs", "1", *args]
    (rec,) = t_queries.main(argv)
    assert rec["engine"] == args[1] and float(rec["avg"]) > 0
    if args[1] == "native":
        ti, _, wd, queries, _ = built
        tdec = TermDecoder(ti, device="cpu")
        want = sum(t_ranked.ranked_or(ti, tdec, wd, q, K).size
                   for q in queries)
        assert rec["total_results"] == str(want)
        assert rec["device"] == "host"


@pytest.mark.parametrize("op", ["wand", "maxscore"])
def test_queries_cli_pruned_ops_raise(built, tmp_path, op):
    """``wand`` and ``maxscore`` no longer raise on the device engine:
    they serve through the pruned fused store."""
    idx, wand, qfile = _cli_files(built, tmp_path)
    recs = t_queries.main(["single_packed_dint", f"{op}:ranked_or", idx, wand,
                           "--queries", qfile, "--device", "cpu", "--runs",
                           "1"])
    pruned, full = recs
    assert pruned["type"] == op and pruned["engine_variant"] == "fused-store"
    assert prunes(built, int(pruned["blocks_kept"]),
                  int(pruned["blocks_total"]))
    assert pruned["blocks_total"] == full["blocks_total"] == full["blocks_kept"]
    assert {"device_queries", "host_fallback_queries", "event_width",
            "prune_rows_host_s"} <= set(pruned)
    assert "device_queries" not in full
    assert int(pruned["metadata_upload_bytes"]) <= int(
        full["metadata_upload_bytes"])


@pytest.mark.parametrize("prune_engine", ["device", "host"])
def test_row_upload_pruned_path(built, prune_engine):
    """``run_op_device(fused=False)``: rows of the surviving blocks,
    uploaded and sort-merged."""
    ti, _, wd, queries, _ = built
    dec = TermDecoder(ti, device="cpu")
    stats, shape, extra = t_queries.run_op_device(
        ti, dec, wd, queries, "wand", 1, K, fused=False,
        prune_engine=prune_engine)
    assert shape[0] == len(queries) and stats["avg"] > 0
    assert extra["prune_engine"] == prune_engine
    assert prunes(built, int(extra["postings_kept"]),
                  int(extra["postings_total"]))
    assert prunes(built, int(extra["blocks_kept"]),
                  int(extra["blocks_total"]))
    _, _, plain = t_queries.run_op_device(ti, dec, wd, queries, "ranked_or",
                                          1, K, fused=False)
    assert plain == {}
    with pytest.raises(ValueError, match="does not support"):
        t_queries.run_op_device(ti, dec, wd, queries, "ranked_and", 1, K)
