"""The fused class launch's trimmed form of the u16 and i32 classes.

A trimmed class keeps, per row, its vidx lanes below n and its table
entries from the end of the planner's zero region to the highest entry
its valid lanes read, each rounded up to 16 bytes, the rows end to end
(``decode_local.TrimmedClass``).  Here, on the CPU: the trimmed form
gives the padded form's raw and exact outputs bit for bit, through
``decode_classes`` and its plain version, on rows that force every edge
(n = 0, n = n_out, n no multiple of 16, every lane in the zero region,
a full table, tables whose zero region is not zero) and on a serving
head; the walk's numpy mirror (``test_torch_k3_grid``) over trimmed
classes copies only each tile's ranges, stays inside its tensors and
stages and writes what the plain version writes; the trimmed bytes of a
planned image follow the per-row rule; the engines keep no padded vidx
or table; and ``decode_classes`` refuses classes whose n, start table
and data disagree, padded triples included.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import fused_refused_cases
from dint_tpu_torch.kernels import decode_local as t_dl
from tests.test_torch_host_copies import write_mixed_collection
from tests.test_torch_k3_grid import (CARD_RESIDENT, WALK_ROWS, WORDS, n_for,
                                      u32, walk_mirror, walk_tiles)

SALTS = (0, 1, 0xFFFFFFFF)
N_OUTS = (128, 256, 1024)
ZERO = t_dl.ZERO_ENTRIES


def edge_class(rows, n_out, words, seed, zero_region=True):
    """A padded (vidx, tab, n) class of numpy arrays: rows of n = 0,
    n = n_out, n = 17 (no multiple of 16), a row whose every lane reads
    the zero region, a row whose table is full (an index of 255), a row
    that reads entry 16 alone, and random rows, each reading indices
    below a bound of its own so that rows keep tables of every length;
    table words with bit 31 and both u16 halves set.  With
    ``zero_region`` every row's first 16 entries are 0, as the planner
    leaves them."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(1, 257, rows)
    vidx = (rng.random((rows, n_out)) * hi[:, None]).astype(np.uint8)
    n = n_for(rows, n_out, seed)
    edges = [(0, None), (n_out, None), (17, None), (n_out, 0), (n_out, 255),
             (5, 1)]
    for r, (k, ix) in enumerate(edges[:rows]):
        n[r] = k
        if ix == 0:
            vidx[r] %= ZERO
        elif ix == 255:
            vidx[r, n_out // 2] = 255
        elif ix == 1:
            vidx[r] = ZERO
    tab = rng.integers(0, 1 << 32, (rows, words), dtype=np.uint64)
    tab[:, ::3] |= 0x80008000
    tab = tab.astype(np.uint32)
    if zero_region:
        tab[:, : ZERO * words // t_dl.TABLE_CLS] = 0
    return vidx, tab.view(np.int32), n


def tensors(cls):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in cls)


def check_forms(n0, c16, c32, n_out):
    """The fused launch over padded triples and over their trimmed forms:
    equal outputs, raw and exact, for every salt, through decode_classes
    and decode_classes_plain."""
    t16 = None if c16 is None else t_dl.trim_class(*c16)
    t32 = None if c32 is None else t_dl.trim_class(*c32)
    for s in SALTS:
        salt = torch.tensor([s])
        for exact in (False, True):
            want = t_dl.decode_classes_plain(n0, c16, c32, salt, exact, n_out)
            got = t_dl.decode_classes(n0, t16, t32, salt, exact, n_out)
            assert torch.equal(got, want), (s, exact)
            assert torch.equal(t_dl.decode_classes_plain(
                n0, t16, t32, salt, exact, n_out), want), (s, exact)
    return t16, t32


@pytest.mark.parametrize("zero_region", [True, False],
                         ids=["zero_region", "no_zero_region"])
@pytest.mark.parametrize("rows", [(5, 67, 9), (0, 37, 0), (3, 0, 40)],
                         ids=["67_9", "u16_alone", "i32_alone"])
@pytest.mark.parametrize("n_out", N_OUTS)
def test_trimmed_equals_padded_on_edge_rows(n_out, rows, zero_region):
    """Every edge row, u16 and i32 classes of row counts no multiple of
    a tile, with and without a zero region (skip 16 and 0): the trimmed
    form's outputs are the padded form's."""
    r0, r16, r32 = rows
    n0 = torch.from_numpy(n_for(r0, n_out, 1)) if r0 else None
    c16 = tensors(edge_class(r16, n_out, 128, 2, zero_region)) if r16 else None
    c32 = tensors(edge_class(r32, n_out, 256, 3, zero_region)) if r32 else None
    t16, t32 = check_forms(n0, c16, c32, n_out)
    for t in (t16, t32):
        if t is not None:
            assert t.skip == (ZERO if zero_region else 0)


@pytest.mark.parametrize("rows", [(37, 301, 19), (3, 40, 2)],
                         ids=["37_301_19", "3_40_2"])
def test_serving_head_of_a_trimmed_class(rows):
    """A serving-sized head (``TrimmedClass.head``) of trimmed classes of
    many rows: views that decode as the padded classes' heads do."""
    r0, r16, r32 = rows
    c16 = tensors(edge_class(700, 256, 128, 4))
    c32 = tensors(edge_class(300, 256, 256, 5))
    t16, t32 = t_dl.trim_class(*c16), t_dl.trim_class(*c32)
    h16, h32 = t16.head(r16), t32.head(r32)
    assert h16.vidx.data_ptr() == t16.vidx.data_ptr()
    assert h16.starts.shape == (r16 + 1, 2)
    n0 = torch.from_numpy(n_for(r0, 256, 6))
    for s in SALTS:
        salt = torch.tensor([s])
        for exact in (False, True):
            want = t_dl.decode_classes_plain(
                n0, tuple(t[:r16] for t in c16), tuple(t[:r32] for t in c32),
                salt, exact)
            got = t_dl.decode_classes(n0, h16, h32, salt, exact)
            assert torch.equal(got, want), (s, exact)


@pytest.mark.parametrize("words", [128, 256], ids=["u16", "i32"])
def test_untrim_gives_back_what_valid_lanes_read(words):
    """``untrim(trim_class(c))`` equals c on every valid lane's vidx and
    on every table entry a valid lane reads."""
    vidx, tab, n = edge_class(90, 256, words, 7)
    v, t, nn = t_dl.untrim(t_dl.trim_class(vidx, tab, n), words)
    valid = np.arange(256)[None, :] < n[:, None]
    np.testing.assert_array_equal(v.numpy()[valid], vidx[valid])
    per = t_dl.TABLE_CLS // words
    rows = np.nonzero(valid)[0]
    w = vidx[valid].astype(np.int64) // per
    np.testing.assert_array_equal(t.numpy()[rows, w], tab[rows, w])
    assert torch.equal(nn, torch.from_numpy(n))


# ---------------------------------------------------------------------------
# The walk's numpy mirror over trimmed classes
# ---------------------------------------------------------------------------


def trimmed_walk_classes(rows, n_out, seed, zero_region):
    """The mirror's {name: numpy array} of classes of ``rows`` = (R0,
    R16, R32) rows, the u16 and i32 classes trimmed (their starts and
    skip beside them), and the padded tensors' decode_classes args."""
    r0, r16, r32 = rows
    cls = {"n0": n_for(r0, n_out, seed)}
    args = [torch.from_numpy(cls["n0"]) if r0 else None]
    for mode, r in ((16, r16), (32, r32)):
        v, t, n = edge_class(r, n_out, WORDS[mode], seed + mode, zero_region)
        vd, td, st, skip = t_dl._trim_host(v, t, n)
        cls.update({f"vidx{mode}": vd, f"tab{mode}": td.view(np.uint32),
                    f"n{mode}": n, f"starts{mode}": st, f"skip{mode}": skip})
        args.append(tensors((v, t, n)) if r else None)
    return cls, args


@pytest.mark.parametrize("zero_region", [True, False],
                         ids=["zero_region", "no_zero_region"])
@pytest.mark.parametrize("resident", [3, 40, CARD_RESIDENT])
@pytest.mark.parametrize("n_out", N_OUTS)
def test_walk_over_trimmed_classes(n_out, resident, zero_region):
    """The walk over trimmed classes, every tile of each class's range
    copied in bulk (none where its rows keep nothing), with grids that
    walk many tiles and grids that take each tile at once: every lane
    written once by its own class's body, and the padded form's values
    in both flags."""
    rows = (45, 101, 27) if resident < CARD_RESIDENT else (9, 37, 5)
    cls, args = trimmed_walk_classes(rows, n_out, resident, zero_region)
    r0, r16, r32 = rows
    for salt in (0, 0xFFFFFFFF):
        for exact in (False, True):
            out, writes, owner, grid, tr = walk_mirror(
                cls, rows, n_out, resident, salt, exact)
            assert (writes == 1).all(), (rows, n_out, resident, salt)
            assert (owner[r0 : r0 + r16] == 16).all()
            assert (owner[r0 + r16 :] == 32).all()
            want = t_dl.decode_classes_plain(*args, torch.tensor([salt]),
                                             exact, n_out).numpy()
            np.testing.assert_array_equal(out, u32(want))
    tiles = sum(walk_tiles(r) for r in rows)
    assert (grid < tiles) == (resident < tiles)
    assert tr <= WALK_ROWS


# ---------------------------------------------------------------------------
# A planned image: the bytes, and what the engines keep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """The port's image engine on a planned single_rect_dint image of the
    mixed collection, on the CPU."""
    from dint_tpu_torch.dictionary import builder
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import common, decode, encode

    root = str(tmp_path_factory.mktemp("trimmed"))
    base = os.path.join(root, "mixed")
    write_mixed_collection(base)
    stream = os.path.join(root, "s.single_rect_dint.bin")
    encode.encode_collection("single_rect_dint", base + ".docs", stream,
                             cache_dir=root)
    kind, policy = common.DINT_KINDS["single_rect_dint"]
    dict_file = os.path.join(root, builder.dict_cache_name(
        base + ".docs", kind, policy or "pack"))
    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary("single_rect_dint",
                                  dict_file).decode_view()
    return decode.StreamDecoder(arena, meta, view, False, "local", None,
                                "cpu").engine


def test_trimmed_bytes_follow_the_row_rule(engine):
    """Each trimmed row of a planned image keeps ceil(n / 16) 16-byte
    words of vidx and, past the zero region (which the planner leaves
    0, so skip is 16), the table words up to its highest valid entry
    rounded up to 16 bytes; padding rows keep nothing; the engine's card
    bytes are those of its n, trimmed classes and start tables."""
    img = engine.image
    held = sum(c.n.numel() * 4 for c in engine._classes if c.rows)
    for c, (vidx, tab, n) in zip(engine._classes[1:], (
            (img.vidx16, img.tab16, img.n16),
            (img.vidx32, img.tab32, img.n32))):
        d = c.data
        assert d.skip == ZERO and not tab[:, : ZERO * tab.shape[1] // 256].any()
        per = t_dl.TABLE_CLS // tab.shape[1]
        valid = np.arange(vidx.shape[1])[None, :] < n[:, None]
        used = np.where(n > 0, np.where(valid, vidx, 0).max(1).astype(
            np.int64) + 1, 0)
        tw = np.maximum(-(-used // per) - ZERO // per, 0)
        st = d.starts.numpy().astype(np.int64)
        R = n.shape[0]
        np.testing.assert_array_equal(np.diff(st[: R + 1, 0]),
                                      -(-n.astype(np.int64) // 16))
        np.testing.assert_array_equal(np.diff(st[: R + 1, 1]), -(-tw // 4))
        assert (np.diff(st[R:], axis=0) == 0).all()  # the padding rows
        assert d.vidx.numel() == 16 * st[-1, 0] and d.tab.numel() == 4 * st[-1, 1]
        assert d.n is c.n and c.rows == d.n.shape[0] > R
        held += d.vidx.numel() + 4 * d.tab.numel() + 4 * d.starts.numel()
    assert engine.card_bytes() == held
    assert held < img.device_bytes()


def test_engines_keep_no_padded_classes(engine):
    """The engine's classes hold their trimmed form and no padded vidx or
    table, its runs pass the trimmed form, and ``padded`` gives triples
    that decode as its runs do."""
    for c in engine._classes:
        assert not hasattr(c, "vidx") and not hasattr(c, "tab")
        assert (c.data is None) == (c.mode == 0)
    n0, c16, c32 = engine.launch_args()
    assert isinstance(c16, t_dl.TrimmedClass)
    assert isinstance(c32, t_dl.TrimmedClass)
    assert all(t.dim() == 1 for t in (c16.vidx, c16.tab, c32.vidx, c32.tab))
    salt = torch.tensor([0x9E3779B9])
    for exact in (False, True):
        want = t_dl.decode_classes(n0, engine.padded(16), engine.padded(32),
                                   salt, exact)
        assert torch.equal(engine._run(salt, exact), want)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

REFUSED = fused_refused_cases("cpu")


@pytest.mark.parametrize("case", range(len(REFUSED)),
                         ids=[label for label, _ in REFUSED])
def test_fused_launch_refuses_classes_at_odds(case):
    """A padded triple whose n has other rows than its vidx and tab, and
    trimmed classes whose n, start table and data disagree: a
    ValueError that names the class, before anything runs."""
    label, args = REFUSED[case]
    which = "u16" if args[1] is not None else "i32"
    with pytest.raises(ValueError, match=f"decode_classes: {which} class"):
        t_dl.decode_classes(*args, torch.tensor([5]))


def test_counters_reset_together():
    """``decode_classes.trimmed`` resets with the other launch counts."""
    t_dl.decode_classes.trimmed = 3
    t_dl.decode_classes.walked = 2
    t_dl.reset_launch_counts()
    assert t_dl.decode_classes.trimmed == t_dl.decode_classes.walked == 0
