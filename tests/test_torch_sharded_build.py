"""The port's sharded build and sharded serving against the reference.

``parallel/build.py`` (list-sharded, serial and in a spawn pool; doc-
and term-range shard sets) must build what the port's ``build_index``
and the reference's builders build, field for field.  ``parallel/
serve.py`` runs on S gloo ranks of the CPU (spawned once per S for the
module, S = 1 and 4) over those shard sets and is held to the
reference's serve functions on a mesh of S virtual devices and to the
host oracle ``ranked_or``, scores within rtol 1e-5; the boolean AND is
exact.  ``create_freq_index --shards 2`` writes the serial build's
index, and the dry run completes on 2 ranks.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from dint_tpu.index import dint_index as j_di
from dint_tpu.parallel import build as j_pbuild
from dint_tpu.parallel import serve as j_serve
from dint_tpu.query import boolean as j_bool
from dint_tpu.query import ranked as j_ranked
from dint_tpu.query.term_decode import TermDecoder as JTermDecoder
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.parallel import build as t_pbuild
from dint_tpu_torch.parallel import dist as pdist
from dint_tpu_torch.parallel import dryrun
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.query.term_decode import TermDecoder
from dint_tpu_torch.tools import create_freq_index
from tests import torch_ranks

K = 10
RTOL = 1e-5
WORLDS = (1, 4)


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tshbuild") / "coll")
    docs, freqs = synth.make_collection(num_lists=40, num_docs=4000, seed=11)
    collection.write_freq_collection(base, docs, freqs, num_docs=4000)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, 4000))
    return base


def assert_index_equal(a, b):
    assert a.kind == b.kind and a.policy == b.policy
    assert a.num_docs == b.num_docs
    for f in ("list_n", "block_ptr", "block_max", "docs_end", "block_end",
              "arena"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for d in ("docs_dict", "freqs_dict"):
        va, vb = getattr(a, d).decode_view(), getattr(b, d).decode_view()
        np.testing.assert_array_equal(va.table, vb.table)
        np.testing.assert_array_equal(va.lengths, vb.lengths)


@pytest.fixture(scope="module")
def reference_sharded(coll, tmp_path_factory):
    """The reference's serial list-sharded build of each kind."""
    cache = str(tmp_path_factory.mktemp("jcache"))
    return {kind: j_pbuild.build_index_sharded(coll, kind=kind,
                                               cache_dir=cache, n_workers=3,
                                               serial=True)
            for kind in ("single", "multi")}


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_sharded_serial_ranges_identical(coll, reference_sharded, kind,
                                         tmp_path):
    cache = str(tmp_path)
    full = t_di.build_index(coll, kind=kind, cache_dir=cache)
    sharded = t_pbuild.build_index_sharded(coll, kind=kind, cache_dir=cache,
                                           n_workers=3, serial=True)
    assert_index_equal(sharded, full)
    assert_index_equal(sharded, reference_sharded[kind])


def test_sharded_process_pool_identical(coll, reference_sharded, tmp_path):
    cache = str(tmp_path)
    full = t_di.build_index(coll, kind="single", cache_dir=cache)
    sharded = t_pbuild.build_index_sharded(coll, kind="single",
                                           cache_dir=cache, n_workers=2,
                                           serial=False)
    assert_index_equal(sharded, full)
    assert_index_equal(sharded, reference_sharded["single"])


def test_create_freq_index_shards_writes_the_serial_index(coll, tmp_path):
    out = {}
    for name, extra in (("serial", []), ("sharded", ["--shards", "2"])):
        out[name] = str(tmp_path / f"{name}.npz")
        create_freq_index.main(["single_packed_dint", coll, out[name],
                                "--cache-dir", str(tmp_path)] + extra)
    with np.load(out["serial"]) as a, np.load(out["sharded"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f], f)


def queries_of(full):
    rng = np.random.default_rng(5)
    nonempty = [t for t in range(full.num_lists) if full.list_n[t]]
    qs = [[int(t) for t in rng.choice(nonempty, size=int(rng.integers(1, 4)),
                                      replace=False)]
          for _ in range(8)]
    # one query over the first and the last term shard, one that
    # repeats a term
    qs += [[int(nonempty[0]), int(nonempty[-1])],
           [int(nonempty[3]), int(nonempty[3]), int(nonempty[9])]]
    return qs


@pytest.fixture(scope="module", params=WORLDS, ids=lambda S: f"S{S}")
def served(request, coll, tmp_path_factory):
    """S-shard doc and term sets built by the port, the full index and
    wand data, every sharded serve on S gloo ranks, and the reference's
    ranked_or of every query over the full index."""
    S = request.param
    root = tmp_path_factory.mktemp(f"served{S}")
    paths = {"doc_shards": str(root / "dsh"), "term_shards": str(root / "tsh"),
             "index": str(root / "full.npz"), "wand": str(root / "w.npz")}
    workers = 2 if S > 1 else 1
    dsh = t_pbuild.build_doc_sharded(coll, paths["doc_shards"], S,
                                     n_workers=workers)
    tsh = t_pbuild.build_term_sharded(coll, paths["term_shards"], S,
                                      n_workers=workers)
    full = t_di.build_index(coll, kind="single", cache_dir=str(root))
    full.save(paths["index"])
    t_ranked.build_wand_data(coll).save(paths["wand"])
    qs = queries_of(full)
    and_qs = [q for q in qs if len(q) >= 2] + [[1, 2, 3]]
    res = pdist.run_ranks(torch_ranks.serve_body, S, "cpu",
                          (paths, qs, and_qs, K), timeout_s=300)
    jwdata = j_ranked.WandData.load(paths["wand"])
    jfull = j_di.DintIndex.load(paths["index"])
    jdec = JTermDecoder(jfull)
    return {"S": S, "paths": paths, "dsh": dsh, "tsh": tsh, "full": full,
            "queries": qs, "and_queries": and_qs, "res": res,
            "mesh": Mesh(np.array(jax.devices()[:S]), ("dp",)),
            "jwdata": jwdata, "jfull": jfull, "jdec": jdec,
            "oracle": [j_ranked.ranked_or(jfull, jdec, jwdata, q, k=K)
                       for q in qs]}


def test_doc_and_term_shard_sets_equal_reference(served, coll,
                                                 tmp_path_factory):
    S = served["S"]
    if S == 1:
        # one shard is the whole collection, re-indexed
        assert_index_equal(served["dsh"].shards[0], served["tsh"].shards[0])
        assert int(served["dsh"].doc_hi[0]) == served["dsh"].num_docs
        return
    root = tmp_path_factory.mktemp("jshards")
    jd = j_pbuild.build_doc_sharded(coll, str(root / "dsh"), S)
    jt = j_pbuild.build_term_sharded(coll, str(root / "tsh"), S)
    for got, want in ((served["dsh"], jd), (served["tsh"], jt)):
        assert len(got.shards) == len(want.shards) == S
        for a, b in zip(got.shards, want.shards):
            assert_index_equal(a, b)
        np.testing.assert_array_equal(got.df, want.df)
        assert got.num_docs == want.num_docs
    for f in ("doc_lo", "doc_hi"):
        np.testing.assert_array_equal(getattr(served["dsh"], f),
                                      getattr(jd, f))
    for f in ("term_lo", "term_hi"):
        np.testing.assert_array_equal(getattr(served["tsh"], f),
                                      getattr(jt, f))


def _check_topk(got, want_ref, oracle):
    """Every rank returns the same top-k; its finite scores equal the
    reference's within RTOL and the oracle's, with as many results."""
    (v, ids), rv = got[0], np.asarray(want_ref[0])
    for r in got[1:]:
        np.testing.assert_array_equal(r[0], v)
        np.testing.assert_array_equal(r[1], ids)
    for qi, want in enumerate(oracle):
        n = want.shape[0]
        np.testing.assert_allclose(v[qi][:n], want, rtol=RTOL)
        np.testing.assert_allclose(v[qi][:n], rv[qi][:n], rtol=RTOL)
        assert not np.isfinite(v[qi][n:]).any()


@pytest.mark.parametrize("layout", ["doc", "term"])
def test_shard_set_serving(served, layout):
    mesh, qs = served["mesh"], served["queries"]
    norm = served["jwdata"].norm_lens
    if layout == "doc":
        want = j_serve.serve_ranked_doc_sharded(
            mesh, j_pbuild.DocShardedIndex.load(
                served["paths"]["doc_shards"]), norm, qs, k=K)
    else:
        want = j_serve.serve_ranked_term_sharded(
            mesh, j_pbuild.TermShardedIndex.load(
                served["paths"]["term_shards"]), norm, qs, k=K)
    _check_topk([r[layout] for r in served["res"]], want, served["oracle"])


@pytest.mark.parametrize("pruned", [False, True],
                         ids=["unpruned", "pruned"])
def test_serve_ranked_sharded(served, pruned):
    want = j_serve.serve_ranked_sharded(served["mesh"], served["jfull"],
                                        served["jdec"], served["jwdata"],
                                        served["queries"], k=K, pruned=pruned)
    key = "pruned" if pruned else "unpruned"
    _check_topk([r[key] for r in served["res"]], want, served["oracle"])


def test_serve_boolean_doc_sharded_exact(served):
    and_qs = served["and_queries"]
    want = j_serve.serve_boolean_doc_sharded(
        j_pbuild.DocShardedIndex.load(served["paths"]["doc_shards"]), and_qs)
    dec = TermDecoder(served["full"], device="cpu")
    decoded = dec.decode_docids(sorted({t for q in and_qs for t in q}))
    for r in served["res"]:
        for qi, q in enumerate(and_qs):
            got = r["and"][qi]
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want[qi])
            np.testing.assert_array_equal(got, j_bool.and_query(decoded, q))


def test_serving_refuses_a_shard_count_other_than_the_ranks(served,
                                                           monkeypatch):
    """Each rank serves exactly one shard: a 4-shard set on one rank
    (or a 1-shard set on four) raises instead of dropping shards."""
    import torch.distributed as tdist

    from dint_tpu_torch.parallel import serve as t_serve

    other = 4 if served["S"] == 1 else 1
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: other)
    with pytest.raises(ValueError, match="shard count"):
        t_serve.serve_ranked_doc_sharded(
            None, served["dsh"], served["jwdata"].norm_lens,
            served["queries"], device="cpu")


def test_dryrun_multichip_two_ranks(capsys):
    summary = dryrun.dryrun_multichip(2, device="cpu")
    assert summary["ranks"] == 2 and summary["backend"] == "gloo"
    assert summary["queries"] == 6
    assert summary["ladder_ints"] > 0 and summary["stats_mass"] > 0
    assert "dryrun_multichip ok: 2 gloo ranks" in capsys.readouterr().out
