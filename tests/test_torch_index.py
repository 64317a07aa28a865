"""The port's DINT index and its host codecs against the reference.

Both packages build the same small collections (40 lists, 30,000 docs,
avg_len 400, seed 11, uniform and skewed; list 7 empty, list 8 a single
posting) into `single` and `multi` indexes from the same files, each
training its own dictionaries.  Every index array must be identical,
what one package saves the other loads, and the host copies
(interpolative, dint, the batch parser, wand data, boolean ops) equal
the reference's.  Every comparison is exact.
"""

import os

import numpy as np
import pytest

from dint_tpu.codecs import dint as j_dint
from dint_tpu.codecs import ef as j_ef
from dint_tpu.codecs import interpolative as j_interp
from dint_tpu.index import dint_index as j_di
from dint_tpu.query import boolean as j_boolean
from dint_tpu.query import lazy_decode as j_lazy
from dint_tpu.query import ranked as j_ranked
from dint_tpu_torch.codecs import dint as t_dint
from dint_tpu_torch.codecs import interpolative as t_interp
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.query import boolean as t_boolean
from dint_tpu_torch.query import lazy_decode as t_lazy
from dint_tpu_torch.query import ranked as t_ranked
from dint_tpu_torch.tools import create_freq_index, create_wand_data

SHAPES = ("uniform", "skew")
KINDS = ("single", "multi")
ARRAYS = ("list_n", "block_ptr", "block_max", "docs_end", "block_end",
          "arena")
NUM_DOCS = 30_000


def write_serve_collection(base, shape):
    """The fixture collection of tests/test_device_serve.py:19-46, with
    its .sizes file; returns (docs, freqs)."""
    if shape == "skew":
        docs, freqs = synth.make_skewed_collection(40, NUM_DOCS, seed=11,
                                                   avg_len=400)
    else:
        docs, freqs = synth.make_collection(40, NUM_DOCS, seed=11,
                                            avg_len=400)
    docs[7] = np.zeros(0, np.uint32)
    freqs[7] = np.zeros(0, np.uint32)
    docs[8] = docs[8][:1]
    freqs[8] = freqs[8][:1]
    collection.write_freq_collection(base, docs, freqs, NUM_DOCS)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, NUM_DOCS))
    return docs, freqs


def build_both(root, base, kind):
    """{pkg: DintIndex} built by each package with its own dictionary
    cache."""
    out = {}
    for pkg, mod in (("jax", j_di), ("torch", t_di)):
        cache = os.path.join(root, f"cache_{kind}_{pkg}")
        out[pkg] = mod.build_index(base, kind=kind, cache_dir=cache)
    return out


@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """{shape: (root, base, docs, freqs)}."""
    out = {}
    for shape in SHAPES:
        root = str(tmp_path_factory.mktemp(f"tidx_{shape}"))
        base = os.path.join(root, "c")
        docs, freqs = write_serve_collection(base, shape)
        out[shape] = (root, base, docs, freqs)
    return out


@pytest.fixture(scope="module")
def indexes(collections):
    """{(shape, kind): {pkg: DintIndex}}."""
    return {
        (shape, kind): build_both(collections[shape][0],
                                  collections[shape][1], kind)
        for shape in SHAPES for kind in KINDS
    }


CASES = [(s, k) for s in SHAPES for k in KINDS]
IDS = [f"{s}-{k}" for s, k in CASES]


def assert_same_index(a, b):
    assert a.kind == b.kind and a.policy == b.policy
    assert a.num_docs == b.num_docs
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_build_index_arrays_equal(indexes, case):
    idx = indexes[case]
    assert_same_index(idx["jax"], idx["torch"])
    assert idx["torch"].list_n[7] == 0 and idx["torch"].list_n[8] == 1


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_size_stats_equal(indexes, case):
    idx = indexes[case]
    assert idx["torch"].size_stats() == idx["jax"].size_stats()


@pytest.mark.parametrize("u,n", [(1, 1), (40, 40), (1000, 3), (123457, 40),
                                 (1 << 32, 6000), (5, 1000)])
def test_ef_bitsize_matches_reference(u, n):
    assert t_di.ef_bitsize(u, n) == j_ef.compact_elias_fano.bitsize(
        j_ef.PARAMS, u, n)


def _dict_views_equal(a, b):
    va, vb = a.decode_view(), b.decode_view()
    np.testing.assert_array_equal(va.table, vb.table)
    np.testing.assert_array_equal(va.offsets, vb.offsets)
    np.testing.assert_array_equal(va.lengths, vb.lengths)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_save_loads_in_reference(indexes, case, tmp_path):
    built = indexes[case]["torch"]
    path = str(tmp_path / "port.npz")
    built.save(path)
    back = j_di.DintIndex.load(path)
    assert back.docs_end is None
    back.ensure_docs_end()
    assert_same_index(back, built)
    _dict_views_equal(back.docs_dict, built.docs_dict)
    _dict_views_equal(back.freqs_dict, built.freqs_dict)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_reference_save_loads_in_port(indexes, case, tmp_path):
    built = indexes[case]["jax"]
    path = str(tmp_path / "ref.npz")
    built.save(path)
    back = t_di.DintIndex.load(path)
    assert back.docs_end is None
    back.ensure_docs_end()  # the port's batch parser recovers the split
    assert_same_index(back, built)
    _dict_views_equal(back.docs_dict, built.docs_dict)
    _dict_views_equal(back.freqs_dict, built.freqs_dict)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_host_oracle_readers_match_collection(indexes, collections, case):
    idx = indexes[case]["torch"]
    _, _, docs, freqs = collections[case[0]]
    for i in range(idx.num_lists):
        if not docs[i].shape[0]:
            assert idx.list_blocks(i)[0] == idx.list_blocks(i)[1]
            continue
        np.testing.assert_array_equal(t_di.list_docids_host(idx, i), docs[i])
        np.testing.assert_array_equal(t_di.list_freqs_host(idx, i), freqs[i])
    jidx = indexes[case]["jax"]
    for i in (0, 8, 13, 39):
        np.testing.assert_array_equal(t_di.list_docids_host(idx, i),
                                      j_di.list_docids_host(jidx, i))


def _full_blocks(idx, docs=True):
    """(starts, limits, sizes, ctxs, b_bits) of every full DINT block's
    docs (or freqs) half, as ensure_docs_end and TermDecoder walk them."""
    out = ([], [], [], [], [])
    for i in range(idx.num_lists):
        p0, p1 = idx.list_blocks(i)
        n = int(idx.list_n[i])
        for b in range(p0, p1):
            size = min(256, n - (b - p0) * 256)
            if size < 256:
                continue
            s = idx.block_start(b) if docs else int(idx.docs_end[b])
            e = int(idx.docs_end[b]) if docs else int(idx.block_end[b])
            ctx, bb = 0, 16
            if idx.kind == "multi":
                sc = int(idx.arena[s])
                ctx, bb = sc % 6, (16 if sc < 6 else 8)
                s += 1
            for lst, v in zip(out, (s, e, size, ctx, bb)):
                lst.append(v)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_batch_parser_matches_reference(indexes, case):
    idx = indexes[case]["torch"]
    for docs, view in ((True, idx.docs_dict.decode_view()),
                       (False, idx.freqs_dict.decode_view())):
        units = _full_blocks(idx, docs)
        assert units[0], "the fixture has full blocks"
        tv, tc = t_lazy.decode_units_fast_batch(idx.arena, *units[:3], view,
                                                *units[3:])
        jv, jc = j_lazy.decode_units_fast_batch(idx.arena, *units[:3], view,
                                                *units[3:])
        assert tc == jc
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(a, b)
        s, lim, sz, ctx, bb = (u[0] for u in units)
        ta = t_lazy.decode_unit_fast(idx.arena, s, lim, sz, view, ctx, bb)
        ja = j_lazy.decode_unit_fast(idx.arena, s, lim, sz, view, ctx, bb)
        np.testing.assert_array_equal(ta[0], ja[0])
        assert ta[1] == ja[1]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dint_decode_oracles_match_reference(indexes, case):
    idx = indexes[case]["torch"]
    view = idx.docs_dict.decode_view()
    starts, _, sizes, ctxs, bits = _full_blocks(idx, True)
    for k in range(0, len(starts), max(1, len(starts) // 12)):
        a = np.zeros(256, np.uint32)
        b = np.zeros(256, np.uint32)
        pa = t_dint.decode_single(view, idx.arena, starts[k], 256, a, 0,
                                  bits[k], ctxs[k])
        pb = j_dint.decode_single(view, idx.arena, starts[k], 256, b, 0,
                                  bits[k], ctxs[k])
        assert pa == pb
        np.testing.assert_array_equal(a, b)
        if idx.kind == "multi":
            a[:] = 0
            b[:] = 0
            pos = starts[k] - 1  # the selector byte
            assert (t_dint.decode_multi(view, idx.arena, pos, 256, a)
                    == j_dint.decode_multi(view, idx.arena, pos, 256, b))
            np.testing.assert_array_equal(a, b)


def test_interpolative_copy_matches_reference():
    rng = np.random.default_rng(21)
    specs, buf = [], bytearray()
    for n in (1, 2, 3, 17, 128, 255):
        for known in (True, False):
            vals = rng.integers(0, 1 << int(rng.integers(1, 20)), n)
            vals = vals.astype(np.uint32)
            s = int(vals.astype(np.int64).sum())
            sv = s if known else t_interp.UNKNOWN_SUM
            tb = t_interp.encode_block(vals, sv)
            assert tb == j_interp.encode_block(vals, sv)
            assert t_interp.encoded_bits(np.cumsum(vals)[:-1], 0, s) == \
                j_interp.encoded_bits(np.cumsum(vals)[:-1], 0, s)
            specs.append((len(buf), n, sv))
            buf += tb
            got, pos = t_interp.decode_block(tb, 0, n, sv)
            np.testing.assert_array_equal(got, vals)
            assert pos == len(tb)
    arr = np.frombuffer(bytes(buf) + b"\0" * 8, np.uint8)
    tb = t_interp.decode_blocks_batch(arr, specs)
    jb = j_interp.decode_blocks_batch(arr, specs)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)


def test_wand_data_equal_and_cross_load(collections, tmp_path):
    base = collections["skew"][1]
    tw = t_ranked.build_wand_data(base)
    jw = j_ranked.build_wand_data(base)
    for f in ("norm_lens", "max_term_weight", "block_maxw", "block_ptr"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f))
    tw.save(str(tmp_path / "t"))
    jw.save(str(tmp_path / "j"))
    back_j = j_ranked.WandData.load(str(tmp_path / "t.npz"))
    back_t = t_ranked.WandData.load(str(tmp_path / "j.npz"))
    for f in ("norm_lens", "max_term_weight", "block_maxw", "block_ptr"):
        np.testing.assert_array_equal(getattr(back_j, f), getattr(tw, f))
        np.testing.assert_array_equal(getattr(back_t, f), getattr(jw, f))
    assert t_ranked.query_weights_from(tw.max_term_weight * 0 + 5, NUM_DOCS,
                                       [3, 1, 3]) == \
        j_ranked.query_weights_from(jw.max_term_weight * 0 + 5, NUM_DOCS,
                                    [3, 1, 3])


def test_boolean_host_ops_match_reference(collections, tmp_path):
    _, _, docs, _ = collections["uniform"]
    decoded = dict(enumerate(docs))
    for q in ([0, 1], [3, 3, 5], [7, 2], [8, 0, 9], [], [11]):
        np.testing.assert_array_equal(t_boolean.and_query(decoded, q),
                                      j_boolean.and_query(decoded, q))
        np.testing.assert_array_equal(t_boolean.or_query(decoded, q),
                                      j_boolean.or_query(decoded, q))
    p = tmp_path / "q.txt"
    p.write_text("1 2 3\n\n 4\t5 \n7\n")
    assert t_boolean.parse_query_log(str(p)) == \
        j_boolean.parse_query_log(str(p)) == [[1, 2, 3], [4, 5], [7]]
    assert t_boolean.dedup_terms([5, 1, 5]) == [1, 5]


def test_cli_tools_build_what_the_reference_loads(collections, indexes,
                                                  tmp_path):
    _, base, _, _ = collections["uniform"]
    out = str(tmp_path / "idx.npz")
    idx = create_freq_index.main(["multi_packed_dint", base, out,
                                  "--cache-dir", str(tmp_path)])
    assert_same_index(idx, indexes[("uniform", "multi")]["jax"])
    back = j_di.DintIndex.load(out)
    back.ensure_docs_end()
    assert_same_index(back, idx)
    w = create_wand_data.main([base, str(tmp_path / "w")])
    np.testing.assert_array_equal(
        j_ranked.WandData.load(str(tmp_path / "w.npz")).block_maxw,
        w.block_maxw)
    # the other families, ported since: a block kind builds the
    # reference's file; an EF index holds no empty list (this collection
    # has one), and both packages refuse it alike
    from dint_tpu.index import block_index as j_bi
    from dint_tpu.index import freq_index as j_fi

    out = str(tmp_path / "qmx.npz")
    blk = create_freq_index.main(["block_qmx", base, out])
    np.testing.assert_array_equal(blk.arena,
                                  j_bi.build_block_index(base, "qmx").arena)
    assert np.load(out)["arena"].tobytes() == blk.arena.tobytes()
    with pytest.raises(AssertionError):
        create_freq_index.main(["ef", base])
    with pytest.raises(AssertionError):
        j_fi.build_freq_index(base, "ef")
