"""The port's lazy block cache and cursors against the reference's.

One collection from ``synth`` with a seed (40 lists over 50,000 docs,
uniform and skewed, as tests/test_bmw_device.py:14-37, with one empty and
one single-posting list) is indexed once by the port and saved; both
packages load the files.  ``BlockCache`` blocks, ``docs_end_of`` and the
decode counters, and ``Cursor.next`` / ``next_geq`` walks are compared
exactly (integers).
"""

import os

import numpy as np
import pytest

from dint_tpu.index import dint_index as j_di
from dint_tpu.query import lazy_decode as j_lazy
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.query import lazy_decode as t_lazy
from dint_tpu_torch.query import ranked as t_ranked

NUM_LISTS = 40
NUM_DOCS = 50_000
EMPTY, SINGLE = 7, 8


def write_bmw_collection(base, shape):
    """The 40-list fixture collection with its .sizes file; list EMPTY
    holds nothing and list SINGLE one posting.  Returns (docs, freqs)."""
    make = (synth.make_skewed_collection if shape == "skew"
            else synth.make_collection)
    docs, freqs = make(NUM_LISTS, NUM_DOCS, seed=31, avg_len=2000)
    docs[EMPTY] = np.zeros(0, np.uint32)
    freqs[EMPTY] = np.zeros(0, np.uint32)
    docs[SINGLE] = docs[SINGLE][:1]
    freqs[SINGLE] = freqs[SINGLE][:1]
    collection.write_freq_collection(base, docs, freqs, NUM_DOCS)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, NUM_DOCS))
    return docs, freqs


def build_files(root, shape, kind="single"):
    """Index and wand data files under ``root``, made once by the port;
    returns (index path, wand path, docs, freqs)."""
    base = os.path.join(root, "c")
    docs, freqs = write_bmw_collection(base, shape)
    idx_path = os.path.join(root, "idx.npz")
    t_di.build_index(base, kind=kind, cache_dir=root).save(idx_path)
    wand = os.path.join(root, "w")
    t_ranked.build_wand_data(base).save(wand)
    return idx_path, wand + ".npz", docs, freqs


def load_both(idx_path):
    """(port index, reference index) loaded from one file, both with the
    docs/freqs split offsets recovered."""
    ti, ji = t_di.DintIndex.load(idx_path), j_di.DintIndex.load(idx_path)
    ti.ensure_docs_end()
    ji.ensure_docs_end()
    return ti, ji


@pytest.fixture(scope="module",
                params=[("uniform", "single"), ("uniform", "multi"),
                        ("skew", "single"), ("skew", "multi")],
                ids=lambda p: "-".join(p))
def built(request, tmp_path_factory):
    shape, kind = request.param
    root = str(tmp_path_factory.mktemp(f"lazy_{shape}_{kind}"))
    idx_path, _, docs, freqs = build_files(root, shape, kind)
    return idx_path, docs, freqs


def counters(cache):
    return (cache.docs_blocks_decoded, cache.freqs_blocks_decoded,
            cache.postings_scored)


def sample_pairs(index, seed, per_term=3):
    rng = np.random.default_rng(seed)
    pairs = []
    for t in range(NUM_LISTS):
        p0, p1 = index.list_blocks(t)
        if p1 > p0:
            for b in rng.choice(np.arange(p0, p1),
                                size=min(per_term, p1 - p0), replace=False):
                pairs.append((t, int(b)))
            pairs.append((t, p1 - 1))  # the partial last block
    return pairs


@pytest.mark.parametrize("docs_end", ["recovered", "lazy"])
def test_block_cache_blocks_and_counters(built, docs_end):
    idx_path, docs, freqs = built
    if docs_end == "recovered":
        ti, ji = load_both(idx_path)
    else:  # the caches discover each block's split offset by decoding
        ti, ji = t_di.DintIndex.load(idx_path), j_di.DintIndex.load(idx_path)
        assert ti.docs_end is None and ji.docs_end is None
    tc, jc = t_lazy.BlockCache(ti), j_lazy.BlockCache(ji)
    for t, b in sample_pairs(ti, 1):
        p0, _ = ti.list_blocks(t)
        lo = (b - p0) * 256
        td = tc.docs_block(t, b)
        assert td.dtype == np.uint32
        np.testing.assert_array_equal(td, jc.docs_block(t, b))
        np.testing.assert_array_equal(td, docs[t][lo:lo + 256])
        assert tc.docs_end_of(t, b) == jc.docs_end_of(t, b)
        tf = tc.freqs_block(t, b)
        np.testing.assert_array_equal(tf, jc.freqs_block(t, b))
        np.testing.assert_array_equal(tf, freqs[t][lo:lo + 256])
        assert counters(tc) == counters(jc)
    before = counters(tc)
    tc.docs_block(*sample_pairs(ti, 1)[0])  # memoised: no new decode
    assert counters(tc) == before
    tc.reset_counters()
    assert counters(tc) == (0, 0, 0)


def test_block_cache_batches(built):
    idx_path, docs, freqs = built
    ti, ji = load_both(idx_path)
    tc, jc = t_lazy.BlockCache(ti), j_lazy.BlockCache(ji)
    pairs = sample_pairs(ti, 2, per_term=4)
    tc.docs_blocks_batch(pairs[::2])
    jc.docs_blocks_batch(pairs[::2])
    assert counters(tc) == counters(jc)
    tc.freqs_blocks_batch(pairs)
    jc.freqs_blocks_batch(pairs)
    assert counters(tc) == counters(jc)
    assert tc._docs.keys() == jc._docs.keys()
    assert tc._freqs.keys() == jc._freqs.keys()
    for t, b in pairs:
        p0, _ = ti.list_blocks(t)
        lo = (b - p0) * 256
        np.testing.assert_array_equal(tc._docs[b], docs[t][lo:lo + 256])
        np.testing.assert_array_equal(tc._freqs[b], freqs[t][lo:lo + 256])
        np.testing.assert_array_equal(tc._freqs[b], jc._freqs[b])
    done = counters(tc)
    tc.freqs_blocks_batch(pairs)  # everything cached
    assert counters(tc) == done


@pytest.mark.parametrize("term", [0, 3, 19, SINGLE, EMPTY])
def test_cursor_next_walks_the_list(built, term):
    idx_path, docs, freqs = built
    ti, ji = load_both(idx_path)
    tc, jc = t_lazy.BlockCache(ti), j_lazy.BlockCache(ji)
    cur, ref = tc.make_cursor(term), j_lazy.Cursor(jc, term)
    assert cur.size == ref.size == docs[term].shape[0]
    seen_d, seen_f = [], []
    while cur.docid() < NUM_DOCS:
        assert (cur.docid(), cur.position()) == (ref.docid(), ref.position())
        seen_d.append(cur.docid())
        if len(seen_d) % 97 == 0:  # freq blocks decode only when asked
            assert cur.freq() == ref.freq()
            seen_f.append((cur.position(), cur.freq()))
        cur.next()
        ref.next()
    assert ref.docid() == NUM_DOCS and cur.position() == ref.position()
    np.testing.assert_array_equal(np.asarray(seen_d, np.uint32), docs[term])
    for pos, f in seen_f:
        assert f == int(freqs[term][pos])
    assert counters(tc) == counters(jc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cursor_next_geq_walks(built, seed):
    idx_path, docs, freqs = built
    ti, ji = load_both(idx_path)
    tc, jc = t_lazy.BlockCache(ti), j_lazy.BlockCache(ji)
    rng = np.random.default_rng(seed)
    terms = [int(t) for t in rng.choice(NUM_LISTS, 6, replace=False)]
    terms += [EMPTY, SINGLE]
    curs, refs = t_lazy.make_cursors(tc, terms), j_lazy.make_cursors(jc, terms)
    for t, cur, ref in zip(terms, curs, refs):
        target = 0
        while True:
            target += int(rng.integers(0, 3000))
            cur.next_geq(target)
            ref.next_geq(target)
            assert (cur.docid(), cur.position()) == (ref.docid(),
                                                     ref.position())
            want = np.searchsorted(docs[t], target, side="left")
            if want == docs[t].shape[0]:
                assert cur.docid() == NUM_DOCS
                break
            assert cur.docid() == int(docs[t][want]) >= target
            assert cur.freq() == ref.freq() == int(freqs[t][want])
            if rng.random() < 0.3:
                cur.next()
                ref.next()
                target = cur.docid()
        # the skips decoded fewer blocks than the list holds, and the
        # same ones as the reference
    assert counters(tc) == counters(jc)
    total = sum(ti.list_blocks(t)[1] - ti.list_blocks(t)[0] for t in terms)
    assert 0 < tc.docs_blocks_decoded <= total
