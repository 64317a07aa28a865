"""The raw chain-scan engine of the port against the reference.

``kernels/decode_xla.py`` (PyTorch ops), ``kernels/pipeline.py`` and
``StreamDecoder(engine="raw")`` must equal ``dint_tpu``'s on the same
inputs made with numpy from a seed: the visited mask of the log-step
scan on token rows with exception markers, ``decode_units`` (out,
produced, consumed) on clean and dirty units at b=16 and b=8, the bucket
plan field for field, and the whole stream unit for unit.  The ablation
form ``decode_local_rows`` is held to the reference and to
``gather_flat``.  Every comparison is exact (integers).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.config import EXCEPTIONS, NUM_ENTRIES
from dint_tpu.io import collection as j_collection
from dint_tpu.io import synth as j_synth
from dint_tpu.kernels import decode_local as j_dl
from dint_tpu.kernels import decode_xla as j_dx
from dint_tpu.kernels import pipeline as j_pipe
from dint_tpu.tools import decode as j_decode
from dint_tpu.tools import encode as j_encode
from dint_tpu_torch.index import stream as t_stream
from dint_tpu_torch.kernels import decode_local as t_dl
from dint_tpu_torch.kernels import decode_xla as t_dx
from dint_tpu_torch.kernels import pipeline as t_pipe
from dint_tpu_torch.tools import decode as t_decode

TYPES = ("single_rect_dint", "multi_packed_dint")


def i32(a):
    """A numpy array as an int32 tensor (u32 bits kept)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def synthetic_view(seed=5, contexts=2, table_words=4000):
    """A dictionary view with every entry length from 0 to 16, run
    entries longer than 16, and table words with bit 31 set."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 17, size=(contexts, NUM_ENTRIES)).astype(
        np.int32)
    lengths[:, EXCEPTIONS : EXCEPTIONS + 5] = (256, 128, 64, 32, 16)
    lengths[:, :EXCEPTIONS] = 1
    offsets = rng.integers(0, table_words - 16,
                           size=(contexts, NUM_ENTRIES)).astype(np.uint32)
    table = rng.integers(0, 1 << 32, size=table_words + 16,
                         dtype=np.uint64).astype(np.uint32)
    table[-16:] = 0
    return lengths, offsets, table


def dirty_units(b, B, W, seed):
    """(cw, w_valid) of B units of W tokens: dictionary codewords with
    exception markers (0 and 1) and their payload tokens, some units
    ending in an exception, and some tokens past w_valid."""
    rng = np.random.default_rng(seed)
    top = 1 << b
    _, s_small, s_large = t_dx._steps_for(b)
    cw = np.zeros((B, W), np.int32)
    w_valid = np.zeros(B, np.int32)
    for r in range(B):
        q = 0
        limit = int(rng.integers(1, W + 1))
        while q < limit:
            u = rng.random()
            if u < 0.15:
                step, mark = s_small, 0
            elif u < 0.25:
                step, mark = s_large, 1
            else:
                step, mark = 1, int(rng.integers(EXCEPTIONS, top))
            if q + step > W:
                break
            cw[r, q] = mark
            cw[r, q + 1 : q + step] = rng.integers(0, top, step - 1)
            q += step
        if r % 3 == 0 and q + s_large <= W:
            # an exception as the unit's last codeword
            cw[r, q] = 1
            cw[r, q + 1 : q + s_large] = rng.integers(0, top, s_large - 1)
            q += s_large
        w_valid[r] = q
        cw[r, q:] = rng.integers(0, top, W - q)  # past w_valid: noise
    return cw, w_valid


def reference_units(cw, w_valid, n, ctx, view, b, n_out, clean):
    lengths, offsets, table = view
    out = j_dx.decode_units(
        jnp.asarray(cw), jnp.asarray(w_valid), jnp.asarray(n),
        jnp.asarray(ctx), jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(offsets.astype(np.int32)), jnp.asarray(table),
        b=b, n_out=n_out, assume_clean=clean)
    return [np.asarray(x) for x in out]


def port_units(cw, w_valid, n, ctx, view, b, n_out, clean):
    lengths, offsets, table = view
    out = t_dx.decode_units(
        i32(cw), i32(w_valid), i32(n), i32(ctx), i32(lengths),
        i32(offsets), i32(table), b=b, n_out=n_out, assume_clean=clean)
    return [u32(out[0]), out[1].numpy(), out[2].numpy()]


# ---------------------------------------------------------------------------
# decode_xla
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [16, 8])
def test_steps_match_reference(b):
    assert t_dx._steps_for(b) == j_dx._steps_for(b)


@pytest.mark.parametrize("W", [1, 2, 3, 5, 17, 64, 130])
@pytest.mark.parametrize("b", [16, 8])
def test_chain_visited_matches_reference(b, W):
    """Random token rows, a third of them exception markers: the scan's
    visited mask equals the reference's associative scan."""
    rng = np.random.default_rng(W * b)
    cw = rng.integers(EXCEPTIONS, 1 << b, size=(37, W)).astype(np.int32)
    marks = rng.random((37, W))
    cw[marks < 0.2] = 0
    cw[(marks >= 0.2) & (marks < 0.33)] = 1
    want = np.asarray(j_dx._chain_visited(jnp.asarray(cw), b))
    got = t_dx._chain_visited(i32(cw), b).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].all()


def test_chain_visited_composes_later_after_earlier():
    """b=16: a 2-byte exception (marker 0, step 2), two codewords, the
    marker again, two codewords: positions 0, 2, 3, 4, 6, 7 are visited.
    One hand-made row pins the walk besides the random rows."""
    cw = np.array([[0, 9, 9, 7, 0, 9, 9, 7]], np.int32)
    got = t_dx._chain_visited(i32(cw), 16).numpy()[0]
    np.testing.assert_array_equal(
        got, [True, False, True, True, True, False, True, True])
    want = np.asarray(j_dx._chain_visited(jnp.asarray(cw), 16))[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,W", [(16, 1), (16, 2), (16, 64), (16, 1024),
                                 (8, 1), (8, 2), (8, 64), (8, 256)])
def test_decode_units_dirty_matches_reference(b, W):
    """Dirty units (markers 0 and 1, an exception as the last codeword,
    noise past w_valid), zero-length and run entries, table words with
    bit 31 set: out, produced and consumed equal the reference's."""
    view = synthetic_view(seed=W + b)
    n_out = 256 if W <= 256 else 1024
    cw, w_valid = dirty_units(b, 23, W, seed=W * 3 + b)
    rng = np.random.default_rng(W)
    ctx = rng.integers(0, 2, size=23).astype(np.int32)
    n = rng.integers(0, n_out + 1, size=23).astype(np.int32)
    want = reference_units(cw, w_valid, n, ctx, view, b, n_out, False)
    got = port_units(cw, w_valid, n, ctx, view, b, n_out, False)
    for g, w, what in zip(got, want, ("out", "produced", "consumed")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert (want[0] >= 1 << 31).any()  # the sign bit reached the output


@pytest.mark.parametrize("b", [16, 8])
def test_decode_units_clean_matches_reference(b):
    view = synthetic_view(seed=b)
    rng = np.random.default_rng(b)
    cw = rng.integers(EXCEPTIONS, 1 << b, size=(40, 256)).astype(np.int32)
    w_valid = rng.integers(0, 257, size=40).astype(np.int32)
    ctx = rng.integers(0, 2, size=40).astype(np.int32)
    n = rng.integers(0, 257, size=40).astype(np.int32)
    want = reference_units(cw, w_valid, n, ctx, view, b, 256, True)
    got = port_units(cw, w_valid, n, ctx, view, b, 256, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_marks_accumulate_for_zero_length_entries():
    """Visited zero-length entries share their start with the next
    codeword: the output-to-ordinal marks must add up, not overwrite."""
    lengths, offsets, table = synthetic_view(seed=1)
    lengths[0, 100] = 0
    lengths[0, 101] = 3
    cw = np.array([[100, 100, 101, 100, 101]], np.int32)
    args = (cw, np.array([5], np.int32), np.array([6], np.int32),
            np.array([0], np.int32), (lengths, offsets, table), 16, 256, True)
    want = reference_units(*args)
    got = port_units(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][0] == 6
    np.testing.assert_array_equal(got[0][0, :3],
                                  table[offsets[0, 101] : offsets[0, 101] + 3])


def test_tokens_from_arena_matches_reference():
    rng = np.random.default_rng(2)
    arena = rng.integers(0, 256, size=999).astype(np.uint8)
    starts = rng.integers(0, 999, size=30)
    for b in (16, 8):
        np.testing.assert_array_equal(
            t_dx.tokens_from_arena(arena, starts, 64, b),
            j_dx.tokens_from_arena(arena, starts, 64, b))


# ---------------------------------------------------------------------------
# pipeline and StreamDecoder(engine="raw") on encoded streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """A small collection encoded by the reference as both DINT types:
    ({type: (stream, dict file)}, collection basename)."""
    tmp = str(tmp_path_factory.mktemp("torch_raw"))
    base = os.path.join(tmp, "rc")
    docs, freqs = j_synth.make_collection(90, 12000, seed=23, avg_len=70)
    j_collection.write_freq_collection(base, docs, freqs, 12000)
    out = {}
    old = os.getcwd()
    os.chdir(tmp)
    try:
        for t in TYPES:
            stream = os.path.join(tmp, f"raw.{t}.bin")
            j_encode.main([t, base + ".docs", "--out", stream])
            kind = "multi_packed" if t.startswith("multi") else "rectangular"
            out[t] = (stream, os.path.join(
                tmp, f"dict.rc.docs.{kind}.DSF-65536-16"))
    finally:
        os.chdir(old)
    return out, base


def _layout(stream, dict_file, type_name):
    arena, meta = t_stream.load_stream(stream)
    view = t_decode.load_dictionary(type_name, dict_file).decode_view()
    multi = type_name.startswith("multi")
    return arena, meta, view, multi, t_decode.units_from_meta(arena, meta,
                                                              multi)


def _bucket_pairs(arena, lay):
    for bits in (16, 8):
        m = lay.b_bits == bits
        if not m.any():
            continue
        args = (arena, lay.starts[m], lay.byte_lens[m], lay.n[m],
                lay.ctx[m], bits)
        yield bits, j_pipe.plan_buckets(*args), t_pipe.plan_buckets(*args)


@pytest.mark.parametrize("type_name", TYPES)
def test_plan_buckets_match_reference(streams, type_name):
    arena, _, _, _, lay = _layout(*streams[0][type_name], type_name)
    seen = 0
    for bits, jb, tb in _bucket_pairs(arena, lay):
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert (a.W, a.N, a.b, a.clean) == (b.W, b.N, b.b, b.clean)
            for f in ("indices", "cw", "w_valid", "n", "ctx"):
                np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
            seen += 1
    assert seen >= 2
    assert t_pipe.N_CLASSES == j_pipe.N_CLASSES
    assert (t_pipe.B_TILE_CLEAN, t_pipe.B_TILE_DIRTY) == (
        j_pipe.B_TILE_CLEAN, j_pipe.B_TILE_DIRTY)
    prefix_t = t_pipe.small_word_flags(arena, 16)
    for p, q in zip(prefix_t, j_pipe.small_word_flags(arena, 16)):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("type_name", TYPES)
def test_decode_units_on_stream_buckets(streams, type_name):
    """Every tile of the stream (clean and dirty), padded with empty
    rows to the reference engine's tile height as that engine pads it,
    through both decode_units: out, produced and consumed equal."""
    arena, _, view, _, lay = _layout(*streams[0][type_name], type_name)
    kinds = set()
    buckets = []
    for _, _, tb in _bucket_pairs(arena, lay):
        buckets += tb
    jeng = j_pipe.DecodeEngine(view, buckets)
    for bi, r0, rows, cw, wv, n, ctx in jeng.tiles:
        bk = buckets[bi]
        want = j_dx.decode_units(cw, wv, n, ctx, jeng.lengths, jeng.offsets,
                                 jeng.table, b=bk.b, n_out=bk.N,
                                 assume_clean=bk.clean)
        got = port_units(np.asarray(cw), np.asarray(wv), np.asarray(n),
                         np.asarray(ctx), (view.lengths, view.offsets,
                                           view.table),
                         bk.b, bk.N, bk.clean)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        kinds.add((bk.b, bk.clean))
    assert (16, True) in kinds
    if type_name.startswith("multi"):
        assert (8, False) in kinds


@pytest.mark.parametrize("type_name", TYPES)
def test_decode_pass_matches_reference_tile_by_tile(streams, type_name):
    """The raw engine's pass table over every tile of the stream (b = 16
    and 8, clean and dirty in multi_packed): ``decode_pass`` on the CPU
    equal, tile by tile, to ``decode_units_plain`` and to the reference's
    ``decode_units`` on the reference engine's tile (its rows past the
    port's unpadded tile are padding); the engine's tiles are views of
    the pass table, and one pass decodes every unit once."""
    arena, _, view, _, lay = _layout(*streams[0][type_name], type_name)
    buckets = []
    for _, _, tb in _bucket_pairs(arena, lay):
        buckets += tb
    jeng = j_pipe.DecodeEngine(view, buckets)
    teng = t_pipe.DecodeEngine(view, buckets, device="cpu")
    pt = teng.pass_table
    outs = t_dx.decode_pass(pt)
    assert len(outs) == len(teng.tiles) == len(jeng.tiles) == len(pt.specs)
    assert pt.R == sum(bk.indices.shape[0] for bk in buckets)
    kinds = set()
    for jt, tt, got, spec in zip(jeng.tiles, teng.tiles, outs, pt.specs):
        bi, r0, rows, cw, wv, n, ctx = tt
        bk = buckets[bi]
        assert jt[:3] == (bi, r0, rows)
        assert (spec.b, spec.clean, spec.W, spec.N, spec.rows) == (
            bk.b, bk.clean, bk.W, bk.N, rows)
        np.testing.assert_array_equal(cw.numpy(), bk.cw[r0 : r0 + rows])
        assert cw.untyped_storage().data_ptr() == (
            pt.tokens.untyped_storage().data_ptr())
        kw = dict(b=bk.b, n_out=bk.N, assume_clean=bk.clean)
        plain = t_dx.decode_units_plain(cw, wv, n, ctx, teng.lengths,
                                        teng.offsets, teng.table, **kw)
        want = j_dx.decode_units(*jt[3:], jeng.lengths, jeng.offsets,
                                 jeng.table, **kw)
        for g, p, w in zip(got, plain, want):
            assert torch.equal(g, p)
            np.testing.assert_array_equal(u32(g), np.asarray(w)[:rows]
                                          .view(u32(g).dtype))
        kinds.add((bk.b, bk.clean))
    assert (16, True) in kinds
    if type_name.startswith("multi"):
        assert (8, False) in kinds


@pytest.mark.parametrize("type_name", TYPES)
def test_raw_stream_decoder_matches_reference_unit_for_unit(streams,
                                                            type_name):
    arena, meta, view, multi, _ = _layout(*streams[0][type_name], type_name)
    tdec = t_decode.StreamDecoder(arena, meta, view, multi, "raw",
                                  device="cpu")
    jdec = j_decode.StreamDecoder(arena, meta, view, multi, "raw")
    want = {uid: (row, k) for uid, row, k in
            jdec.engine.iter_unit_outputs(jdec.decode_all())}
    got = list(tdec.engine.iter_unit_outputs(tdec.decode_all()))
    assert len(got) == len(want) == len(tdec.layout.starts)
    for uid, row, k in got:
        wrow, wk = want[uid]
        assert k == wk
        np.testing.assert_array_equal(row, wrow)
    expect, _ = j_decode.common.gap_lists_of(streams[1] + ".docs")
    for g, e in zip(tdec.gather_lists(), expect):
        np.testing.assert_array_equal(g, e)
    total = tdec.engine.block_and_check(tdec.decode_all())
    assert total == int(meta.n.sum())
    census = tdec.engine.census()
    assert census["units_clean"] + census["units_dirty"] == len(got)
    assert sum(census["tiles"].values()) == len(tdec.engine.tiles)


@pytest.mark.parametrize("type_name", TYPES)
def test_raw_cli_checks_the_collection(streams, type_name, capsys):
    (stream, dict_file), base = streams[0][type_name], streams[1]
    t_decode.main([type_name, stream, "--dict", dict_file, "--engine", "raw",
                   "--runs", "2", "--check-collection", base + ".docs",
                   "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["check"] == "ok" and rec["engine"] == "raw"
    assert rec["device"] == "cpu" and rec["plan_bytes"] == "0"
    jrec = j_decode.decode_stream(type_name, stream, dict_file, runs=1,
                                  engine="raw")
    assert rec["num_integers"] == jrec["num_integers"]
    assert set(rec) == set(jrec) | {"device", "check"}


def test_raw_engine_default_device_raises_without_cuda(streams, monkeypatch):
    arena, meta, view, multi, _ = _layout(*streams[0]["single_rect_dint"],
                                          "single_rect_dint")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_decode.StreamDecoder(arena, meta, view, multi, "raw")


# ---------------------------------------------------------------------------
# decode_local_rows, the ablation form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def local_plan(streams):
    arena, _, view, _, lay = _layout(*streams[0]["single_rect_dint"],
                                     "single_rect_dint")
    return t_dl.plan_stream(arena, lay.starts, lay.byte_lens, lay.n, lay.ctx,
                            lay.b_bits, view)


@pytest.mark.parametrize("salt", [0, 1, 0xFFFFFFFF])
def test_decode_local_rows_matches_reference_and_gather_flat(local_plan,
                                                             salt):
    p = local_plan
    want = np.asarray(j_dl.decode_local_rows(
        jnp.asarray(p.tokens), jnp.asarray(p.meta), jnp.asarray(p.table),
        jnp.asarray(p.out_n), jnp.uint32(salt)))
    st = torch.tensor([salt], dtype=torch.int64)
    got = t_dl.decode_local_rows(i32(p.tokens), i32(p.meta), i32(p.table),
                                 i32(p.out_n), st)
    np.testing.assert_array_equal(u32(got), want)
    flat = t_dl.gather_flat(i32(t_dl.plan_to_vidx(p)), i32(p.table),
                            i32(p.out_n), st)
    assert torch.equal(got, flat)


def test_onehot_helpers_match_reference():
    rng = np.random.default_rng(9)
    idx = rng.integers(-2, 40, size=(5, 33)).astype(np.int32)
    planes = rng.integers(0, 256, size=(5, 37, 4)).astype(np.int32)
    want = np.asarray(j_dl._onehot_dot(jnp.asarray(idx), jnp.asarray(planes)))
    got = t_dl._onehot_dot(i32(idx), i32(planes))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    bins = rng.integers(0, 50, size=(5, 33)).astype(np.int32)
    w = rng.integers(0, 2, size=(5, 33)).astype(np.int32)
    want = np.asarray(j_dl._onehot_hist(jnp.asarray(bins), jnp.asarray(w), 50))
    np.testing.assert_array_equal(
        t_dl._onehot_hist(i32(bins), i32(w), 50).numpy(), want)
    x = rng.integers(0, 300, size=(5, 64)).astype(np.int32)
    np.testing.assert_array_equal(
        t_dl._cumsum_mxu(i32(x)).numpy(),
        np.asarray(j_dl._cumsum_mxu(jnp.asarray(x))))
