"""The port's native cursor engine against the reference's.

``NativeQueryEngine`` binds the same ``native/query_host.cpp`` (with
``zoo_decode.cpp``) that the reference binds, compiled into the port's
build directory.  Over one collection (40 lists over 9,000 docs, one
empty and one single-posting list, as tests/test_native_query_block.py)
and its files, every op of ``OPS`` must return the reference engine's
result counts and top-k scores bit for bit: for both DINT dictionary
kinds, for every block codec the engine serves, and for the four EF
kinds through the u32 block view, whose arrays must equal the
reference's view.  ``tools.queries --engine native`` reports the same
counts.  Models: tests/test_native_query.py,
tests/test_native_query_block.py.
"""

import os

import numpy as np
import pytest

from dint_tpu.index import block_index as j_bi
from dint_tpu.index import dint_index as j_di
from dint_tpu.index import freq_index as j_fi
from dint_tpu.query import block_view as j_bv
from dint_tpu.query import native_host as j_nh
from dint_tpu.query import ranked as j_ranked
from dint_tpu_torch.index import block_index as t_bi
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.index import freq_index as t_fi
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.query import block_view as t_bv
from dint_tpu_torch.query import native_host as t_nh
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.tools import queries as t_queries

K = 10
NUM_LISTS = 40
NUM_DOCS = 9000
EMPTY, SINGLE = 5, 6
OPS = tuple(t_nh.OPS)
VIEW_FIELDS = ("codec", "num_docs", "list_n", "block_ptr", "block_max",
               "block_end", "docs_end", "arena")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    """(root, basename, wand file, queries); ``basename + "_ef"`` (with
    its wand file ``ROOT/w_ef.npz``) is the same collection with one
    posting in the empty list, since an EF index holds no empty list
    (``write_gamma_nonzero`` of its occurrences) in either package."""
    root = str(tmp_path_factory.mktemp("torch_native"))
    base = os.path.join(root, "c")
    docs, freqs = synth.make_collection(NUM_LISTS, NUM_DOCS, seed=29,
                                        avg_len=150)
    docs[EMPTY], freqs[EMPTY] = np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    docs[SINGLE], freqs[SINGLE] = docs[SINGLE][:1], freqs[SINGLE][:1]
    collection.write_freq_collection(base, docs, freqs, NUM_DOCS)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, NUM_DOCS))
    wand = os.path.join(root, "w")
    t_ranked.build_wand_data(base).save(wand)
    docs[EMPTY], freqs[EMPTY] = docs[0][:1], freqs[0][:1]
    collection.write_freq_collection(base + "_ef", docs, freqs, NUM_DOCS)
    collection.write_sizes_file(
        base + "_ef", synth.doc_sizes_from_lists(docs, freqs, NUM_DOCS))
    t_ranked.build_wand_data(base + "_ef").save(os.path.join(root, "w_ef"))
    rng = np.random.default_rng(8)
    queries = [[int(t) for t in rng.integers(0, NUM_LISTS,
                                             size=int(rng.integers(1, 5)))]
               for _ in range(30)]
    queries += [[EMPTY], [EMPTY, 2], [SINGLE, SINGLE], [SINGLE, 9, 17]]
    return root, base, wand + ".npz", queries


def assert_engines_equal(teng, jeng, queries):
    for op in OPS:
        _, tc, ts = teng.run(op, queries, runs=2, k=K)
        _, jc, js = jeng.run(op, queries, runs=2, k=K)
        np.testing.assert_array_equal(tc, jc, err_msg=op)
        assert (ts is None) == (js is None) == (t_nh.OPS[op] < 4)
        if ts is not None:
            assert ts.shape == (len(queries), K)
            np.testing.assert_array_equal(ts, js, err_msg=op)
    assert int(teng.run("or", queries, runs=2)[1].sum()) > 0


def engines(t_index, j_index, wand):
    return (t_nh.NativeQueryEngine(t_index, t_ranked.WandData.load(wand)),
            j_nh.NativeQueryEngine(j_index, j_ranked.WandData.load(wand)))


def test_library_is_available():
    assert t_nh.available()
    assert set(t_nh.OPS) == set(j_nh.OPS)
    assert t_nh.BLOCK_CODEC_MODES == j_nh.BLOCK_CODEC_MODES


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_dint_kinds_match_reference(coll, kind):
    root, base, wand, queries = coll
    path = os.path.join(root, f"dint_{kind}.npz")
    t_di.build_index(base, kind=kind, cache_dir=root).save(path)
    teng, jeng = engines(t_di.DintIndex.load(path), j_di.DintIndex.load(path),
                         wand)
    assert_engines_equal(teng, jeng, queries)
    view = t_di.DintIndex.load(path).docs_dict.decode_view()
    idx = np.random.default_rng(0).integers(0, view.offsets.shape[-1], 4096)
    assert t_nh.dict_copy_ns(view, idx, runs=2) > 0


@pytest.mark.parametrize("codec", sorted(t_nh.BLOCK_CODEC_MODES))
def test_block_kinds_match_reference(coll, codec):
    root, base, wand, queries = coll
    path = os.path.join(root, f"block_{codec}.npz")
    t_bi.build_block_index(base, codec).save(path)
    teng, jeng = engines(t_bi.BlockIndex.load(path),
                         j_bi.BlockIndex.load(path), wand)
    assert_engines_equal(teng, jeng, queries)


@pytest.mark.parametrize("kind", ["ef", "single", "uniform", "opt"])
def test_ef_kinds_through_the_block_view(coll, kind):
    root, base, _, queries = coll
    wand = os.path.join(root, "w_ef.npz")
    path = os.path.join(root, f"ef_{kind}.npz")
    t_fi.build_freq_index(base + "_ef", kind).save(path)
    ti, ji = t_fi.FreqIndexEF.load(path), j_fi.FreqIndexEF.load(path)
    tv = t_bv.from_ef_index(ti)
    jv = j_bv.from_ef_index(ji)
    assert tv.cold_start_s > 0
    for f in VIEW_FIELDS:
        a, b = getattr(tv, f), getattr(jv, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    teng, jeng = engines(tv, jv, wand)
    assert_engines_equal(teng, jeng, queries)
    # the view decoded through the tool's decoder (docids on the device
    # path for the plain-EF kind) is the same view
    dec = t_fi.EFTermDecoder(ti, device="cpu", device_ef=True)
    np.testing.assert_array_equal(t_bv.from_ef_index(ti, dec).arena, tv.arena)


@pytest.mark.parametrize("kind", ["multi_packed_dint", "block_simple16",
                                  "opt"])
def test_queries_cli_native_engine(coll, kind):
    root, base, wand, queries = coll
    path = os.path.join(root, f"cli_{kind}.npz")
    if kind.startswith("block_"):
        t_bi.build_block_index(base, kind[len("block_"):]).save(path)
        jidx = j_bi.BlockIndex.load(path)
    elif kind == "opt":
        base, wand = base + "_ef", os.path.join(root, "w_ef.npz")
        t_fi.build_freq_index(base, kind).save(path)
        jidx = j_bv.from_ef_index(j_fi.FreqIndexEF.load(path))
    else:
        t_di.build_index(base, kind="multi", cache_dir=root).save(path)
        jidx = j_di.DintIndex.load(path)
    qfile = os.path.join(root, f"q_{kind}.txt")
    with open(qfile, "w") as f:
        f.write("".join(" ".join(map(str, q)) + "\n" for q in queries))
    ops = ("and", "or", "ranked_or", "wand", "maxscore")
    recs = t_queries.main([kind, ":".join(ops), path, wand, "--queries",
                           qfile, "--runs", "2", "--engine", "native",
                           "--device", "cpu"])
    jeng = j_nh.NativeQueryEngine(jidx, j_ranked.WandData.load(wand))
    assert [r["type"] for r in recs] == list(ops)
    for r in recs:
        assert r["engine"] == "native" and r["device"] == "host"
        _, cnt, _ = jeng.run(r["type"], queries, runs=2, k=K)
        assert r["total_results"] == str(int(cnt.sum())), r["type"]
