"""Tests that need an NVIDIA card: each is marked ``cuda`` and skips
itself where ``torch.cuda.is_available()`` is False (every CPU run).

This file imports no JAX and nothing of the reference package, so it
also runs on a host that has neither; from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_card.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the other
files).  Covered: X1's rows entry on views of one uploaded tensor (an
offset slice, unaligned, strided, transposed), ``entry()``'s fused
launch against its plain version and the portable branch,
``tools.scale_test`` at a tiny size through ``--decode`` and ``--serve``
with the launches of its kernels counted, K3 (the zero class) alone and
inside the fused class launch at every n_out against their plain
versions with a guard row after the output, X2 (the EF decode)
against its plain version and the values written, and the tables its
``upload`` refuses on the CPU refused on the card too, X1 over classes
of no words (no launch), X3 (the raw decode of
a pass) against its plain version on ``chip_smoke``'s edge tiles, one at
a time and as one mixed pass, the passes X3's PassTable refuses on the
CPU refused on the card too, and on a small collection's raw engine
(every list exact, one launch a pass),
and X4 (the byte-class wire unpack) against its plain version on edge
classes and through the vbyte wire engine (every value exact, the chain
checksum the host's).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (X2_REFUSED, X3_REFUSED, fused_refused_cases,
                        make_data, x2_edge_arena, x2_refused_specs, x3_args,
                        x3_edge_pass, x3_edge_tiles, x3_refused_case,
                        x4_edge_classes)
from dint_tpu_torch.codecs import ef, ef_device
from dint_tpu_torch.config import BLOCK_SIZE
from dint_tpu_torch.kernels import decode_local as dl
from dint_tpu_torch.kernels import decode_xla as dx
from dint_tpu_torch.kernels import unpack_device as ud
from dint_tpu_torch.utils.bitio import BitBuilder

SALTS = (0, 1, 0xFFFFFFFF)
GUARD = -123456789  # the row after a kernel's output, which it must not touch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def rank_views(seed, ranks=3, rows=5):
    """{w: (one (ranks, rows, words_w) tensor of packed words, the values
    (ranks, rows, 256) u32 they hold)}, for every ladder width."""
    rng = np.random.default_rng(seed)
    out = {}
    for w in ud._LADDER:
        v = rng.integers(0, 1 << w, size=(ranks * rows, BLOCK_SIZE),
                         dtype=np.uint64)
        v[:, 32 // w - 1 :: 32 // w] |= 1 << (w - 1)
        v = v.astype(np.uint32)
        words = ud._pack_w(v, w).reshape(ranks, rows, -1)
        out[w] = (torch.from_numpy(words.view(np.int32)),
                  v.reshape(ranks, rows, BLOCK_SIZE))
    return out


@pytest.mark.cuda
def test_rows_entry_decodes_views_on_the_card(card):
    """X1's rows entry (one launch a call) on rank 1's slice of one
    uploaded tensor, on that slice from its second row (no 16-byte
    boundary), every other row of it and a transposed copy: equal to
    ``ladder_rows_plain`` and to the values packed."""
    whole = {w: (a.to(card), v) for w, (a, v) in rank_views(4).items()}
    cases = [
        ("rank 1", {w: a[1] for w, (a, _) in whole.items()}, slice(None)),
        ("rank 1 from row 1", {w: a[1][1:] for w, (a, _) in whole.items()},
         slice(1, None)),
        ("every other row", {w: a[1][::2] for w, (a, _) in whole.items()},
         slice(None, None, 2)),
        ("transposed copy", {w: a[1].t().contiguous().t()
                             for w, (a, _) in whole.items()}, slice(None)),
    ]
    assert any(a.data_ptr() % 16 for a in cases[1][1].values())
    for label, views, rows in cases:
        before = ud.ladder_rows.launches
        got = ud.ladder_rows(views)
        assert ud.ladder_rows.launches == before + 1
        torch.cuda.synchronize()
        for w, (_, vals) in whole.items():
            assert torch.equal(got[w], ud.ladder_rows_plain(views[w], w)), \
                (label, w)
            np.testing.assert_array_equal(
                got[w].cpu().numpy().view(np.uint32), vals[1][rows],
                err_msg=f"{label} w={w}")


@pytest.mark.cuda
def test_entry_fn_on_the_card(card):
    """``entry()``'s fn is one fused class launch, equal to its plain
    version, and on every valid lane to ``entry("cpu")``."""
    from dint_tpu_torch import entry

    fn, args = entry.entry("cuda")
    before = dl.decode_classes.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert dl.decode_classes.launches == before + 1
    cpu = lambda x: (None if x is None else x.to("cpu")
                     if isinstance(x, dl.TrimmedClass) else x.cpu())
    want = dl.decode_classes_plain(*(cpu(a) for a in args[:3]),
                                   args[3].cpu(), exact=True)
    assert torch.equal(out.cpu(), want)
    eng = dl.LocalDecodeEngine(entry.example_plan("cpu"), device="cpu")
    pfn, pargs = entry.entry("cpu")
    portable = pfn(*pargs)
    rows = out.cpu()[torch.from_numpy(eng._eng_of_plan)]
    valid = (torch.arange(portable.shape[1])[None, :]
             < pargs[2][:, None].to(torch.int64))
    assert torch.equal(rows[valid], portable[valid])


@pytest.mark.cuda
def test_scale_test_on_the_card(card, tmp_path):
    """``tools.scale_test`` at a tiny size on the card: both decode legs
    and the serve spot-check pass, through the fused class launch, X1
    and K4."""
    from dint_tpu_torch.query import device_serve
    from dint_tpu_torch.tools import scale_test

    for m in (dl, ud, device_serve):
        m.reset_launch_counts()
    rec = scale_test.main(["--ints", "2e5", "--num-lists", "200",
                           "--cache-dir", str(tmp_path / "s"), "--decode",
                           "--serve", "--queries", "64", "--runs", "2"])
    assert rec["checks"] == {"gather_collection": "ok",
                             "ladder_collection": "ok",
                             "serve_device_topk_20": "ok"}
    assert dl.decode_classes.launches > 0
    assert ud.ladder_unpack.launches > 0
    assert device_serve.launch_counts()["K4_block_copy"] > 0


def zero_class(rows, n_out, seed):
    """n (rows,) int32 of a zero class: empty rows, full rows, the rest
    random."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, n_out + 1, rows).astype(np.int32)
    n[: min(rows, 3)] = (0, n_out, 1)[: min(rows, 3)]
    return torch.from_numpy(n)


def guarded(rows, n_out, device):
    """(an output view of ``rows`` rows, the whole buffer): one more row
    after the view holds GUARD."""
    buf = torch.full((rows + 1, n_out), GUARD, dtype=torch.int32,
                     device=device)
    return buf[:rows], buf


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [128, 256, 512, 1024])
def test_k3_alone_equals_plain_and_stays_inside(card, n_out):
    """K3 at row counts that are no multiple of a block (and one that
    is), for the three salts: equal to ``zero_plain``, the row after its
    output untouched."""
    per_block = 1024 // (n_out // 4)  # rows of a K3 block
    for rows in (1, 5, 67, 3 * per_block, 3 * per_block + 1, 1000):
        n = zero_class(rows, n_out, rows).to(card)
        for s in SALTS:
            salt = torch.tensor([s], dtype=torch.int64, device=card)
            out, buf = guarded(rows, n_out, card)
            dl.zero(n, salt, n_out, out=out)
            torch.cuda.synchronize()
            assert torch.equal(out, dl.zero_plain(n, salt, n_out)), (rows, s)
            assert (buf[rows] == GUARD).all(), (rows, s)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [128, 256, 512, 1024])
def test_fused_launch_equals_plain_at_every_width(card, n_out):
    """The fused class launch in both flags and for the three salts, with
    every class, with empty classes and with the zero class alone, at row
    counts that are no multiple of a tile, and on mixes of tens of
    thousands of rows whose blocks walk many tiles: equal to its plain
    version, the row after its output untouched, one launch a call,
    counted in ``decode_classes.walked`` exactly where its tiles
    outnumber the card's resident blocks; the same with the u16 and i32
    classes trimmed (``trim_class``; their random tables have no zero
    region, so also with one, skip 16), counted in
    ``decode_classes.trimmed``.  The classes at odds that the CPU
    refuses (``chip_smoke.fused_refused_cases``) are refused on the card
    too, with no launch."""
    rng = np.random.default_rng(n_out)

    def cls(rows, words):
        vidx = torch.from_numpy(rng.integers(0, 256, (rows, n_out))
                                .astype(np.uint8)).to(card)
        tab = torch.from_numpy(rng.integers(0, 1 << 32, (rows, words),
                                            dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(card)
        return vidx, tab, zero_class(rows, n_out, rows + words).to(card)

    n0 = zero_class(77, n_out, 5).to(card)
    c16, c32 = cls(31, 128), cls(9, 256)
    cases = [(n0, c16, c32), (n0, None, None), (None, c16, c32),
             (n0, None, c32), (n0[:1], c16, None)]
    # launches of more tiles than the card holds blocks, so that blocks
    # walk, each class no multiple of a tile: the engines' mix and an
    # i32-heavy one
    cases += [(zero_class(20_001, n_out, 6).to(card), cls(40_003, 128),
               cls(6_005, 256)),
              (zero_class(1_003, n_out, 7).to(card), cls(3_001, 128),
               cls(30_007, 256))]
    def zeroed(c):
        t = c[1].clone()
        t[:, : dl.ZERO_ENTRIES * t.shape[1] // 256] = 0
        return c[0], t, c[2]

    def trim(c):
        return None if c is None else dl.trim_class(*c)

    cases += [(n0_, trim(a), trim(b)) for n0_, a, b in cases
              if a is not None or b is not None]
    cases.append((n0, trim(zeroed(c16)), trim(zeroed(c32))))
    assert cases[-1][1].skip == cases[-1][2].skip == dl.ZERO_ENTRIES
    resident, tile_rows = dl._walk_shape(card, n_out)
    for n0_, c16_, c32_ in cases:
        rows = sum(0 if c is None else c.shape[0]
                   for c in (n0_, c16_ and c16_[2], c32_ and c32_[2]))
        walks = rows > 10_000
        trimmed = any(isinstance(c, dl.TrimmedClass) for c in (c16_, c32_))
        tiles = sum(-(-c.shape[0] // tile_rows)
                    for c in (n0_, c16_ and c16_[2], c32_ and c32_[2])
                    if c is not None)
        assert (tiles > resident) == walks, (rows, tiles, resident)
        for s in SALTS:
            salt = torch.tensor([s], dtype=torch.int64, device=card)
            for exact in (False, True):
                out, buf = guarded(rows, n_out, card)
                before = (dl.decode_classes.launches, dl.decode_classes.walked,
                          dl.decode_classes.trimmed)
                dl.decode_classes(n0_, c16_, c32_, salt, exact, n_out,
                                  out=out)
                assert (dl.decode_classes.launches, dl.decode_classes.walked,
                        dl.decode_classes.trimmed) == (
                    before[0] + 1, before[1] + walks,
                    before[2] + trimmed), rows
                torch.cuda.synchronize()
                want = dl.decode_classes_plain(n0_, c16_, c32_, salt, exact,
                                               n_out)
                assert torch.equal(out, want), (rows, s, exact)
                assert (buf[rows] == GUARD).all(), (rows, s, exact)
    if n_out != dl.N_OUT:
        return
    salt = torch.tensor([5], dtype=torch.int64, device=card)
    for label, args in fused_refused_cases(card):
        which = "u16" if args[1] is not None else "i32"
        before = dl.decode_classes.launches
        with pytest.raises(ValueError, match=f"decode_classes: {which} "
                                             f"class"):
            dl.decode_classes(*args, salt)
        assert dl.decode_classes.launches == before, label


@pytest.mark.cuda
def test_x2_equals_plain_and_the_values(card):
    """X2 (one call counted a call) on ``chip_smoke``'s edge arena (n = 0,
    w = 0, one-word regions, a list of many blocks, values past 2^31)
    and on many short lists:
    equal to ``decode_tensors_plain`` and to the values written, and
    ``decode_lists`` equal to them list by list, the first call's lists
    unchanged after the second reuses the download buffer."""
    words, specs, vals = x2_edge_arena()
    many = [(n, u) for n, u in zip(np.random.default_rng(9).integers(
        1, 40, 3000), np.full(3000, 10_000))]
    bb = BitBuilder()
    mspecs, mvals = [], []
    for k, (n, u) in enumerate(many):
        v = np.sort(np.random.default_rng(k).choice(u, n, replace=False)
                    ).astype(np.uint64)
        mspecs.append((bb.size, int(v[-1]) + 1, int(n)))
        ef.compact_elias_fano.write(bb, v, int(v[-1]) + 1, int(n), ef.PARAMS)
        mvals.append(v)
    kept = []
    for w, sp, vs in ((words, specs, vals), (bb.words(), mspecs, mvals)):
        t = ef_device.upload(w, sp, ef.PARAMS, card)
        before = ef_device.decode_tensors.launches
        got = ef_device.decode_tensors(t)
        assert ef_device.decode_tensors.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, ef_device.decode_tensors_plain(t))
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      np.concatenate(vs).astype(np.uint32))
        lists = ef_device.decode_lists(w, sp, ef.PARAMS, card)
        assert len(lists) == len(vs)
        for a, v in zip(lists, vs):
            assert a.dtype == np.uint64
            np.testing.assert_array_equal(a, v)
        kept.append((lists, vs))
    for lists, vs in kept:
        for a, v in zip(lists, vs):
            np.testing.assert_array_equal(a, v)


@pytest.mark.cuda
@pytest.mark.parametrize("label", X2_REFUSED)
def test_x2_upload_refuses_on_the_card(card, label):
    """Each EF spec the CPU's ``upload`` and ``decode_lists`` refuse
    (``chip_smoke``'s ``x2_refused_specs``) is refused on the card too,
    with ValueError and no launch of X2; a dict of uploaded tensors, and
    a table resized after its upload, are refused by
    ``decode_tensors``."""
    before = ef_device.decode_tensors.launches
    words, specs = x2_refused_specs(label)
    for entry in (ef_device.upload, ef_device.decode_lists):
        with pytest.raises(ValueError, match="ef_decode"):
            entry(words, specs, ef.PARAMS, card)
    words, specs, _ = x2_edge_arena()
    t = ef_device.upload(words, specs, ef.PARAMS, card)
    with pytest.raises(ValueError, match="tables that upload builds"):
        ef_device.decode_tensors(dict(t))
    t["lists"].resize_(1, 4)
    with pytest.raises(ValueError, match="lists must be contiguous"):
        ef_device.decode_tensors(t)
    assert ef_device.decode_tensors.launches == before


@pytest.mark.cuda
def test_x1_classes_with_no_words_launch_nothing(card):
    """LadderClasses whose classes hold no words: no X1 launch (a grid of
    no block is a CUDA launch error), the empty outputs returned, as on
    the CPU."""
    lc = ud.LadderClasses([(w, torch.zeros((w, 0, 128), dtype=torch.int32,
                                           device=card), None)
                           for w in (4, 8)], card)
    before = ud.ladder_unpack.launches
    outs = ud.ladder_unpack(lc, torch.tensor([1], dtype=torch.int64,
                                             device=card))
    torch.cuda.synchronize()
    assert ud.ladder_unpack.launches == before
    assert [tuple(o.shape) for o in outs] == [(4, 8, 0, 128), (8, 4, 0, 128)]


@pytest.mark.cuda
def test_x3_equals_plain_on_edge_tiles(card):
    """X3 on every edge tile (b = 16 and 8, dirty and clean, W no multiple
    of 32, w_valid 0 and 1, exceptions across run, warp and chunk edges,
    runs, wrapping table offsets), one launch a tile through
    ``decode_units`` and all of them as one mixed pass (rows a warp and
    rows a block take, both widths and kinds in one row table) through
    ``decode_pass``, one launch: val, produced and consumed equal to the
    plain version."""
    for label, args, b, n_out, clean in x3_edge_tiles():
        ts = x3_args((label, args), card)
        before = dx.decode_pass.launches
        got = dx.decode_units(*ts, b=b, n_out=n_out, assume_clean=clean)
        assert dx.decode_pass.launches == before + 1
        torch.cuda.synchronize()
        want = dx.decode_units_plain(*ts, b=b, n_out=n_out,
                                     assume_clean=clean)
        for g, w in zip(got, want):
            assert torch.equal(g, w), label
    labels, pt = x3_edge_pass(card)
    before = dx.decode_pass.launches
    got = dx.decode_pass(pt)
    assert dx.decode_pass.launches == before + 1
    torch.cuda.synchronize()
    for label, g, w in zip(labels, got, dx.decode_pass_plain(pt)):
        for a, b in zip(g, w):
            assert torch.equal(a, b), label


@pytest.mark.cuda
@pytest.mark.parametrize("label", X3_REFUSED)
def test_x3_pass_table_refuses_on_the_card(card, label):
    """Each pass that the CPU's PassTable refuses (``chip_smoke``'s
    ``x3_refused_case``: slots past the buffer, two tiles on one row, a
    row in no tile, overlapping slots, tokens past the buffer) is refused
    on the card too, with ValueError, before its row table is uploaded:
    X3's launch count stays as it was."""
    call = x3_refused_case(label, card)
    before = dx.decode_pass.launches
    with pytest.raises(ValueError, match="X3: tile"):
        call()
    assert dx.decode_pass.launches == before


@pytest.mark.cuda
def test_raw_engine_runs_on_x3(card, tmp_path):
    """A small collection's two DINT streams through the raw engine on the
    card: every list equal to the collection, X3 once a pass (one launch
    over every tile), each tile of the pass equal to the plain version."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import common, decode

    base, data = make_data(str(tmp_path / "c"), 2026, 300, 200_000, 300.0)
    expect, _ = common.gap_lists_of(base + ".docs")
    for t, (stream, dict_file) in data.items():
        arena, meta = stream_mod.load_stream(stream)
        view = decode.load_dictionary(t, dict_file).decode_view()
        dec = decode.StreamDecoder(arena, meta, view, t.startswith("multi"),
                                   "raw", device=card)
        before = dx.decode_pass.launches
        for got, want in zip(dec.gather_lists(), expect):
            np.testing.assert_array_equal(got, want)
        assert dx.decode_pass.launches == before + 1
        assert len(dec.engine.tiles) > 1
        got = dec.decode_all()
        assert dx.decode_pass.launches == before + 2
        want = dx.decode_pass_plain(dec.engine.pass_table)
        for i, (g, w) in enumerate(zip(got, want)):
            for a, b in zip(g, w):
                assert torch.equal(a, b), (t, i)


@pytest.mark.cuda
def test_x4_equals_plain_on_edge_classes(card):
    """X4 (one launch a call) on classes of every length 1-5 in both group
    widths, with an empty class and sizes no multiple of four or of a
    block, for the three salts: equal to its plain version."""
    for label, bc in x4_edge_classes(card):
        for s in SALTS:
            salt = torch.tensor([s], dtype=torch.int64, device=card)
            before = ud.byteclass_unpack.launches
            got = [o.clone() for o in ud.byteclass_unpack(bc, salt)]
            assert ud.byteclass_unpack.launches == before + 1
            torch.cuda.synchronize()
            for g, w in zip(got, bc.plain(salt)):
                assert torch.equal(g, w), (label, s)


@pytest.mark.cuda
def test_byte_wire_engine_runs_on_x4(card, tmp_path):
    """vbyte and varintgb lists through ByteClassEngine on the card: every
    value in stream order equal to the lists, one X4 launch a chained
    run, the chain checksum equal to the host engine's."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.index import vroom_zoo

    rng = np.random.default_rng(3)
    lists = []
    for n in (1, 9, 300, 5000):
        v = rng.integers(0, 1 << 10, n).astype(np.uint64)
        v[rng.integers(0, n, max(1, n // 5))] = rng.integers(
            1 << 20, 1 << 32, max(1, n // 5), dtype=np.uint64)
        lists.append(v.astype(np.uint32))
    for codec in ("vbyte", "varintgb"):
        path = str(tmp_path / f"s.{codec}")
        payloads = [vroom_zoo.encode_list_zoo(codec, g)[0] for g in lists]
        stream_mod.write_stream(path, payloads, [len(g) for g in lists],
                                [int(g.astype(np.int64).sum())
                                 for g in lists])
        arena, meta = stream_mod.load_stream(path)
        plan = ud.plan_byteclass(codec, arena, meta)
        eng = ud.ByteClassEngine(plan, device=card)
        np.testing.assert_array_equal(eng.decode_all_ordered(),
                                      np.concatenate(lists))
        before = ud.byteclass_unpack.launches
        card_salt = int(eng.chain(4).item())
        assert ud.byteclass_unpack.launches == before + 4
        host = ud.ByteClassEngine(plan, device="cpu")
        assert card_salt == int(host.chain(4).item())
