"""The port's per-unit decode engine, docid rebuild and TermDecoder
against the reference.

``LocalDecodeEngine`` always lays its plan out in the three width
classes and runs the class kernels' plain twins on the CPU; its outputs
must equal the reference engine's split path (Pallas in interpret mode,
``FORCE_SPLIT_INTERPRET``) row for row, and its per-unit outputs the
reference's flat XLA path.  The docid rebuild is held to the reference's
wrapping u32 arithmetic with bases near 2^31 and 2^32, and TermDecoder's
docids and freqs to the collection and to the reference's, for every
term.  Every comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.index import dint_index as j_di
from dint_tpu.kernels import decode_local as j_dl
from dint_tpu.query import term_decode as j_td
from dint_tpu_torch.index import dint_index as t_di
from dint_tpu_torch.kernels import decode_local as t_dl
from dint_tpu_torch.kernels import planner_native
from dint_tpu_torch.query import term_decode as t_td
from tests.test_torch_host_copies import write_mixed_collection
from tests.test_torch_index import write_serve_collection

KINDS = ("single", "multi")
SHAPES = ("uniform", "skew")
RT = 32


def _u32(t):
    return t.numpy().view(np.uint32)


def index_units(idx, docs=True):
    """(starts, byte_lens, sizes, ctxs, b_bits, bases) of the full DINT
    blocks' docs (or freqs) halves, as TermDecoder gathers them."""
    td = t_td.TermDecoder.__new__(t_td.TermDecoder)
    td.index = idx
    out = ([], [], [], [], [], [])
    for t, b, pos, size, base in td._block_geometry(range(idx.num_lists)):
        if size != 256:
            continue
        s = idx.block_start(b) if docs else int(idx.docs_end[b])
        e = int(idx.docs_end[b]) if docs else int(idx.block_end[b])
        ctx, bits = 0, 16
        if idx.kind == "multi":
            sc = int(idx.arena[s])
            ctx, bits = sc % 6, (16 if sc < 6 else 8)
            s += 1
        for lst, v in zip(out, (s, e - s, size, ctx, bits, base)):
            lst.append(v)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def mixed_indexes(tmp_path_factory):
    """{kind: port DintIndex} over the mixed collection, whose docid
    plans hold all three width classes."""
    root = str(tmp_path_factory.mktemp("ttd_mixed"))
    base = os.path.join(root, "mixed")
    write_mixed_collection(base)
    return {k: t_di.build_index(base, kind=k, cache_dir=root) for k in KINDS}


def _plan(idx, docs=True):
    starts, lens, sizes, ctxs, bits, bases = index_units(idx, docs)
    view = (idx.docs_dict if docs else idx.freqs_dict).decode_view()
    args = (idx.arena, starts, lens, sizes, ctxs, bits, view)
    return t_dl.plan_stream(*args), j_dl.plan_stream(*args), sizes, bases


@pytest.mark.parametrize("kind", KINDS)
def test_plan_stream_matches_reference(mixed_indexes, kind):
    tplan, jplan, _, _ = _plan(mixed_indexes[kind])
    assert tplan.rows == jplan.rows > 0
    for f in ("tokens", "meta", "table", "out_n", "unit_id", "out_pos"):
        np.testing.assert_array_equal(getattr(tplan, f), getattr(jplan, f))
    np.testing.assert_array_equal(t_dl.plan_to_vidx(tplan),
                                  j_dl.plan_to_vidx(jplan))


@pytest.fixture
def split_reference(monkeypatch):
    monkeypatch.setattr(j_dl, "FORCE_SPLIT_INTERPRET", True)
    j_dl._pallas_split_fns.cache_clear()
    yield
    j_dl._pallas_split_fns.cache_clear()


@pytest.mark.parametrize("kind", KINDS)
def test_engine_layout_matches_reference_split(mixed_indexes, kind,
                                               split_reference):
    tplan, jplan, _, _ = _plan(mixed_indexes[kind])
    jeng = j_dl.LocalDecodeEngine(jplan)
    teng = t_dl.LocalDecodeEngine(tplan, device="cpu")
    assert jeng.use_pallas and teng.row_tile == jeng.row_tile
    assert {c.mode: c.rows for c in teng._classes} == {
        m: p for m, _, p in jeng._classes}
    for f in ("eng_unit_id", "eng_out_pos", "eng_out_n"):
        np.testing.assert_array_equal(getattr(teng, f), getattr(jeng, f))
    np.testing.assert_array_equal(teng.row_carry(), jeng.row_carry())


@pytest.mark.parametrize("kind", KINDS)
def test_decode_all_matches_reference_split(mixed_indexes, kind,
                                            split_reference):
    tplan, jplan, _, _ = _plan(mixed_indexes[kind])
    jeng = j_dl.LocalDecodeEngine(jplan, row_tile=RT)
    teng = t_dl.LocalDecodeEngine(tplan, row_tile=RT, device="cpu")
    rows = {c.mode: c.rows for c in teng._classes}
    assert min(rows.values()) > 0, f"a width class is empty: {rows}"
    got = teng.decode_all()
    assert got.dtype == torch.int32 and got.shape == (teng.rows, t_dl.N_OUT)
    np.testing.assert_array_equal(_u32(got), np.asarray(jeng.decode_all()))


@pytest.mark.parametrize("docs", [True, False], ids=["docs", "freqs"])
@pytest.mark.parametrize("kind", KINDS)
def test_units_match_reference_flat(mixed_indexes, kind, docs):
    tplan, jplan, sizes, _ = _plan(mixed_indexes[kind], docs)
    jeng = j_dl.LocalDecodeEngine(jplan)
    assert not jeng.use_pallas  # the flat XLA path
    teng = t_dl.LocalDecodeEngine(tplan, device="cpu")
    ju = jeng.gather_units(jeng.decode_all(), len(sizes), sizes)
    tu = teng.gather_units(teng.decode_all(), len(sizes), sizes)
    assert len(tu) == len(ju) == len(sizes)
    for a, b in zip(tu, ju):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def _bases(n, top, seed):
    """Unit bases just below ``top`` (u32), spaced so that many units'
    docids cross it."""
    rng = np.random.default_rng(seed)
    return ((top - rng.integers(0, 1 << 20, n)) & 0xFFFFFFFF).astype(
        np.uint32)


@pytest.mark.parametrize("top", [1 << 31, 1 << 32], ids=["2^31", "2^32"])
@pytest.mark.parametrize("kind", KINDS)
def test_decode_docids_all_matches_reference(mixed_indexes, kind, top,
                                             monkeypatch):
    tplan, jplan, sizes, _ = _plan(mixed_indexes[kind])
    bases = _bases(len(sizes), top, 3)
    teng = t_dl.LocalDecodeEngine(tplan, row_tile=RT, device="cpu")
    got = teng.decode_docids_all(bases)
    # flat XLA path: per-unit docids
    jflat = j_dl.LocalDecodeEngine(jplan)
    ju = jflat.gather_units(jflat.decode_docids_all(bases), len(sizes), sizes)
    for a, b in zip(teng.gather_units(got, len(sizes), sizes), ju):
        np.testing.assert_array_equal(a, b)
    # split path (interpret mode): the engine-order rows themselves
    monkeypatch.setattr(j_dl, "FORCE_SPLIT_INTERPRET", True)
    j_dl._pallas_split_fns.cache_clear()
    try:
        jsplit = j_dl.LocalDecodeEngine(jplan, row_tile=RT)
        np.testing.assert_array_equal(
            _u32(got), np.asarray(jsplit.decode_docids_all(bases)))
    finally:
        j_dl._pallas_split_fns.cache_clear()


@pytest.mark.parametrize("top", [1 << 31, 1 << 32], ids=["2^31", "2^32"])
def test_docid_rebuild_matches_reference(top):
    rng = np.random.default_rng(9)
    R, N = 48, t_dl.N_OUT
    gaps = rng.integers(0, 1 << 12, (R, N)).astype(np.uint32)
    gaps[::5] = rng.integers(0, 1 << 32, (gaps[::5].shape), dtype=np.uint64)
    gaps[1] = 0
    n = rng.integers(0, N + 1, R).astype(np.int32)
    n[:3] = (0, N, 1)
    base = _bases(R, top, 4)
    want = np.asarray(j_dl._docid_rebuild(
        jnp.asarray(gaps), jnp.asarray(base), jnp.asarray(n[:, None])))
    got = t_dl._docid_rebuild(torch.from_numpy(gaps.view(np.int32)),
                              torch.from_numpy(base.astype(np.int64)),
                              torch.from_numpy(n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)


def test_empty_plan_decodes_nothing():
    plan = t_dl.LocalPlan(
        np.zeros((0, t_dl.W_TOKENS), np.int32),
        np.zeros((0, t_dl.W_TOKENS), np.int32),
        np.zeros((0, t_dl.TABLE_CLS), np.uint32), np.zeros(0, np.int32),
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    eng = t_dl.LocalDecodeEngine(plan, device="cpu")
    assert eng.decode_all().shape == (0, t_dl.N_OUT)
    assert eng.gather_units(eng.decode_docids_all(np.zeros(0)), 0, []) == []


def test_plan_stream_raises_with_the_build_error(monkeypatch):
    from dint_tpu_torch.utils import nativebuild

    monkeypatch.setattr(planner_native, "get_lib", lambda: None)

    monkeypatch.setitem(nativebuild.errors, "libdintplan.so",
                        "dint_planner.cpp:1: error: boom")
    with pytest.raises(RuntimeError, match="boom.*prefer_native=False"):
        t_dl.plan_stream(np.zeros(4, np.uint8), [0], [2], [1], [0], [16],
                         None)


# ---------------------------------------------------------------------------
# TermDecoder on the serving fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_indexes(tmp_path_factory):
    """{(shape, kind): (port index, reference index, docs, freqs)}."""
    out = {}
    for shape in SHAPES:
        root = str(tmp_path_factory.mktemp(f"ttd_{shape}"))
        base = os.path.join(root, "c")
        docs, freqs = write_serve_collection(base, shape)
        for kind in KINDS:
            ti = t_di.build_index(base, kind=kind, cache_dir=root + "/t")
            ji = j_di.build_index(base, kind=kind, cache_dir=root + "/j")
            out[(shape, kind)] = (ti, ji, docs, freqs)
    return out


CASES = [(s, k) for s in SHAPES for k in KINDS]


@pytest.mark.parametrize("case", CASES, ids=[f"{s}-{k}" for s, k in CASES])
def test_term_decoder_exact(serve_indexes, case):
    ti, ji, docs, freqs = serve_indexes[case]
    terms = list(range(ti.num_lists))
    tdec = t_td.TermDecoder(ti, device="cpu")
    jdec = j_td.TermDecoder(ji)
    td, tf = tdec.decode_docids(terms), tdec.decode_freqs(terms)
    jd, jf = jdec.decode_docids(terms), jdec.decode_freqs(terms)
    for t in terms:
        for got, want in ((td[t], docs[t]), (td[t], jd[t]),
                          (tf[t], freqs[t]), (tf[t], jf[t])):
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want, err_msg=f"term {t}")
    assert td[7].shape == (0,) and td[8].shape == (1,)
    assert set(tdec.timings) >= {"plan", "upload", "decode", "gather_units"}


def test_term_decoder_after_load_and_in_pieces(serve_indexes, tmp_path):
    ti, _, docs, freqs = serve_indexes[("skew", "multi")]
    ti.save(str(tmp_path / "i.npz"))
    loaded = t_di.DintIndex.load(str(tmp_path / "i.npz"))
    dec = t_td.TermDecoder(loaded, device="cpu")  # runs ensure_docs_end
    np.testing.assert_array_equal(loaded.docs_end, ti.docs_end)
    # two batches, the second one overlapping the first (cached terms)
    a = dec.decode_docids([3, 0, 3])
    assert list(a) == [3, 0]
    b = dec.decode_docids([0, 5, 39])
    for t in (0, 3, 5, 39):
        got = a.get(t, b.get(t))
        np.testing.assert_array_equal(got, docs[t])
    np.testing.assert_array_equal(dec.decode_freqs([39])[39], freqs[39])


def test_term_decoder_lazy_cache_and_device(serve_indexes, monkeypatch):
    ti = serve_indexes[("uniform", "single")][0]
    dec = t_td.TermDecoder(ti, device="cpu")
    from dint_tpu_torch.query.lazy_decode import BlockCache

    cache = dec.lazy_cache  # the host block cache, memoised
    assert isinstance(cache, BlockCache) and dec.lazy_cache is cache
    assert cache.index is ti and dec._lazy_totals is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_td.TermDecoder(ti)
