"""K3's grid (``csrc/decode_gather.cu``) alone, and the fused class
launch's walk over row tiles, mirrored in numpy on the CPU.

The kernels run on the card only.  Here their launch shapes are read
from the source (``THREADS``, ``LANES_PER_BLOCK``, ``ZERO_VEC``,
``TABLE_CLS``, ``WALK_ROWS``, ``WALK_STAGES``).  A numpy mirror of
``zero_blocks`` and ``zero_rows`` lists, for every block and thread, the
16-byte stores K3 makes and the values it writes: each output lane of
the class written exactly once, nothing past the class (a last block
only partly filled), the values those of ``zero_plain``.  A mirror of
the fused launch's walk (``walk_tile``, ``walk_issue``, the ring of
stages and its mbarrier phases, the three bodies' stores) holds, for
grids that take every tile at once and grids capped below the tile
count, that every lane of the (R0 + R16 + R32, n_out) buffer is written
exactly once by its own class's body, that every bulk copy is 16-byte
sized and aligned and stays inside its tensor and its stage, and that
the values equal ``decode_classes_plain``, which
``test_torch_decode_local`` holds to the reference's Pallas bodies.
"""

import os
import re

import numpy as np
import pytest
import torch

from dint_tpu_torch.kernels import decode_local as t_dl

SRC = os.path.join(os.path.dirname(t_dl.__file__), "csrc", "decode_gather.cu")
N_OUTS = [128, 256, 512, 1024]
SALTS = (0, 1, 0xFFFFFFFF)


def constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", open(SRC).read())
    assert m, f"{name} not found in {SRC}"
    return int(m.group(1))


THREADS = constant("THREADS")
LANES_PER_BLOCK = constant("LANES_PER_BLOCK")
ZERO_VEC = constant("ZERO_VEC")


def zero_blocks(rows, n_out):
    return -(-(rows * (n_out // 4)) // (THREADS * ZERO_VEC))


def zero_stores(rows, n_out, block):
    """The int4 indices block ``block`` of a zero class of ``rows`` rows
    stores to (relative to the class's first row), each thread's
    ZERO_VEC of them THREADS apart."""
    t = np.arange(THREADS)[None, :]
    k = np.arange(ZERO_VEC)[:, None]
    g = block * THREADS * ZERO_VEC + k * THREADS + t
    return g[g < rows * (n_out // 4)]


def i32(salt):
    """The int32 whose bits are the u32 ``salt``."""
    return salt - (1 << 32) if salt >= 1 << 31 else salt


def zero_values(g, n, fill, n_out, exact=False):
    """The four lanes of each int4 ``g``: the fill where the lane is below
    its row's n, 0 elsewhere; the exact output is 0 and reads no n."""
    if exact:
        return np.zeros((g.size, 4), np.int64)
    per_row = n_out // 4
    nr = n[g // per_row][:, None].astype(np.int64)
    j = (g % per_row)[:, None] * 4 + np.arange(4)[None, :]
    return np.where(j < nr, fill, 0)


def n_for(rows, n_out, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, n_out + 1, rows).astype(np.int32)
    n[: min(rows, 3)] = np.array([0, n_out, 1], np.int32)[: min(rows, 3)]
    return n


def rows_cases(n_out):
    """Row counts: one row, a few, no multiple of a block, exactly three
    blocks, three blocks and a row, and one more than a gather block."""
    per_block = THREADS * ZERO_VEC // (n_out // 4)
    return [1, 5, 67, 3 * per_block, 3 * per_block + 1,
            LANES_PER_BLOCK // n_out + 1]


def test_launch_shape_read_from_the_source():
    assert THREADS == 256 and LANES_PER_BLOCK == 1024
    assert ZERO_VEC >= 1 and (THREADS * ZERO_VEC * 4) % 1024 == 0


@pytest.mark.parametrize("n_out", N_OUTS)
def test_k3_alone_writes_each_lane_once(n_out):
    """The stand-alone K3 grid: every lane of the class written exactly
    once, no store past the class, the values of ``zero_plain`` for the
    three salts and for the exact output."""
    for rows in rows_cases(n_out):
        n = n_for(rows, n_out, rows)
        for salt in SALTS:
            fill = i32(salt)
            writes = np.zeros(rows * n_out // 4, np.int64)
            out = np.full((rows * n_out // 4, 4), -7, np.int64)
            for b in range(zero_blocks(rows, n_out)):
                g = zero_stores(rows, n_out, b)
                assert g.size, (rows, b)  # no block without a store
                assert (g < rows * n_out // 4).all()
                np.add.at(writes, g, 1)
                out[g] = zero_values(g, n, fill, n_out)
                out_exact = zero_values(g, n, fill, n_out, exact=True)
                assert not out_exact.any()
            assert (writes == 1).all(), (n_out, rows)
            want = t_dl.zero_plain(torch.from_numpy(n),
                                   torch.tensor([salt]), n_out).numpy()
            np.testing.assert_array_equal(out.reshape(rows, n_out), want)


# ---------------------------------------------------------------------------
# The fused class launch: a persistent walk over row tiles
# ---------------------------------------------------------------------------

WALK_ROWS = constant("WALK_ROWS")
WALK_STAGES = constant("WALK_STAGES")
WALK_THREADS = constant("WALK_THREADS")
TABLE_CLS = constant("TABLE_CLS")
WORDS = {16: TABLE_CLS // 2, 32: TABLE_CLS}
CARD_RESIDENT = 132 * 8  # more blocks than any case below has tiles


def walk_tiles(rows, tile_rows=WALK_ROWS):
    return -(-rows // tile_rows)


def walk_of(rows, resident):
    """``walk_of``: the rows of a launch's tiles, the fewest (a multiple
    of 4, up to WALK_ROWS) whose tiles the resident blocks take at once,
    else WALK_ROWS; and the launch's tiles."""
    for tr in range(4, WALK_ROWS + 1, 4):
        tiles = sum(walk_tiles(r, tr) for r in rows)
        if tiles <= resident or tr == WALK_ROWS:
            return tr, tiles


def walk_tile(rows, tr, t):
    """(mode, rows, first row in its class, first row in the output) of
    tile ``t`` of ``tr`` rows of classes of ``rows`` = (R0, R16, R32)
    rows: the u16 class's tiles, then the i32 class's, then the zero
    class's."""
    r0, r16, r32 = rows
    t16, t32 = walk_tiles(r16, tr), walk_tiles(r32, tr)
    if t < t16:
        mode, n, base = 16, r16, r0
    elif t < t16 + t32:
        t, mode, n, base = t - t16, 32, r32, r0 + r16
    else:
        t, mode, n, base = t - t16 - t32, 0, r0, 0
    row0 = t * tr
    return mode, min(tr, n - row0), row0, base + row0


def stage_layout(n_out):
    """(vidx, table, n, starts) byte offsets of a stage, and its size:
    room for WALK_ROWS rows of the i32 class, whatever the tile's rows,
    and a trimmed tile's row starts."""
    tab, n = WALK_ROWS * n_out, WALK_ROWS * (n_out + TABLE_CLS * 4)
    return 0, tab, n, n + WALK_ROWS * 4, n + WALK_ROWS * 12


def walk_issue(tile, tr, n_out, exact, cls=None):
    """The bulk copies that start a tile's loads, each (tensor name, byte
    offset in it, bytes, byte offset in the stage), and the bytes the
    stage's mbarrier is told to expect.  A trimmed class (``cls`` holds
    its ``starts``) copies the range its tile's rows keep of vidx and
    table, none where they keep none, and a whole tile's starts."""
    mode, rows, row0, _ = tile
    _, tab_off, n_off, st_off, _ = stage_layout(n_out)
    st = None if cls is None else cls.get(f"starts{mode}")
    copies = []
    if mode and st is not None:
        (v0, t0), (v1, t1) = st[row0], st[row0 + rows]
        copies += [c for c in ((f"vidx{mode}", 16 * v0, 16 * (v1 - v0), 0),
                               (f"tab{mode}", 16 * t0, 16 * (t1 - t0),
                                tab_off)) if c[2]]
        if rows == tr:
            copies.append((f"starts{mode}", row0 * 8, tr * 8, st_off))
    elif mode:
        words = WORDS[mode]
        copies += [(f"vidx{mode}", row0 * n_out, rows * n_out, 0),
                   (f"tab{mode}", row0 * words * 4, rows * words * 4, tab_off)]
    if rows == tr and not (mode == 0 and exact):
        copies.append((f"n{mode}", row0 * 4, tr * 4, n_off))
    return copies, sum(c[2] for c in copies)


def u32(a):
    return np.asarray(a, np.int64) & 0xFFFFFFFF


def walk_mirror(cls, rows, n_out, resident, salt, exact):
    """The fused launch's walk in numpy, thread by thread and stage by
    stage: every block's tiles, each tile's bulk copies into its stage of
    the ring, the mbarrier phase each wait passes on, and the int4 each
    thread stores.  Returns (the output buffer, the count of writes of
    each lane, the body that wrote each lane, the grid, the tiles' rows)."""
    tr, tiles = walk_of(rows, resident)
    grid = min(tiles, resident)
    total = sum(rows)
    per_row, row_shift = n_out // 4, (n_out // 4).bit_length() - 1
    _, tab_off, n_off, st_off, stage_bytes = stage_layout(n_out)
    raw = {k: v.view(np.uint8).reshape(-1) for k, v in cls.items()
           if isinstance(v, np.ndarray)}
    out = np.full((total, n_out), -7, np.int64)
    writes = np.zeros((total, n_out), np.int64)
    owner = np.full((total, n_out), -1, np.int64)
    add = 0 if exact else salt
    for b in range(grid):
        ring = np.zeros((WALK_STAGES, stage_bytes), np.uint8)
        owned = [None] * WALK_STAGES  # the tile each stage holds
        phases = [0] * WALK_STAGES  # mbarrier phases completed

        def issue(t, s):
            tile = walk_tile(rows, tr, t)
            copies, expect = walk_issue(tile, tr, n_out, exact, cls)
            for name, src, nbytes, dst in copies:
                assert nbytes % 16 == 0 and src % 16 == 0 and dst % 16 == 0
                assert src + nbytes <= raw[name].size, (name, tile)
                assert dst + nbytes <= stage_bytes
                ring[s, dst : dst + nbytes] = raw[name][src : src + nbytes]
            assert expect < 1 << 20  # an mbarrier's transaction count
            owned[s] = t
            phases[s] += 1  # the copies land: the phase completes

        mine = list(range(b, tiles, grid))
        for k, t in enumerate(mine[:WALK_STAGES]):
            issue(t, k)
        for k, t in enumerate(mine):
            s, parity = k % WALK_STAGES, (k // WALK_STAGES) & 1
            # try_wait.parity passes once the phase of that parity is done
            assert owned[s] == t and phases[s] == k // WALK_STAGES + 1
            assert phases[s] % 2 != parity
            mode, trows, row0, out0 = walk_tile(rows, tr, t)
            q = np.arange(trows * per_row)  # int4 q: thread q % WALK_THREADS
            lr, j = q >> row_shift, (q & (per_row - 1)) * 4
            lane = j[:, None] + np.arange(4)
            if mode == 0 and exact:
                nr = np.zeros_like(lr)
            elif trows == tr:
                nr = ring[s, n_off : n_off + 4 * tr].view(np.int32)[lr]
            else:  # a class's short last tile: its threads read n
                nr = cls[f"n{mode}"][row0 + lr]
            valid = lane < nr[:, None]
            if mode == 0:
                val = np.full(lane.shape, salt, np.int64)
            else:
                st = cls.get(f"starts{mode}")
                skip = cls.get(f"skip{mode}", 0)
                if st is None:  # padded: row lr at lr * n_out, lr * words
                    vo, to = lr * n_out, lr * WORDS[mode]
                else:  # trimmed: at its starts less the first row's
                    rs = (ring[s, st_off : st_off + 8 * tr].view(np.int32)
                          .reshape(tr, 2) if trows == tr
                          else st[row0 : row0 + trows]).astype(np.int64)
                    vo = 16 * (rs[lr, 0] - rs[0, 0])
                    to = 4 * (rs[lr, 1] - rs[0, 1])
                at = vo[:, None] + lane  # the uchar4 each thread reads
                assert (at < tr * n_out).all()
                ix = ring[s, at].astype(np.int64)
                tab = ring[s, tab_off:n_off].view(np.uint32)
                e = ix - skip  # the entry in the stage's table of the row
                word = to[:, None] + (e if mode == 32 else e >> 1)
                read = valid & (e >= 0)
                assert (word[read] < tab.size).all()
                w = tab[np.where(read, word, 0)].astype(np.int64)
                if mode == 32:
                    val = np.where(e >= 0, w, 0)
                else:
                    val = np.where(e >= 0, np.where(e & 1, w >> 16, w)
                                   & 0xFFFF, 0)
                    val = u32(val) + add
            rr = out0 + lr[:, None] + 0 * lane
            out[rr, lane] = np.where(valid, u32(val), 0)
            np.add.at(writes, (rr, lane), 1)
            owner[rr, lane] = mode
            nxt = k + WALK_STAGES
            if nxt < len(mine):
                issue(mine[nxt], s)
    return out, writes, owner, grid, tr


def walk_classes(rows, n_out, seed):
    """{name: numpy array} of classes of ``rows`` = (R0, R16, R32) rows."""
    rng = np.random.default_rng(seed)
    r0, r16, r32 = rows
    cls = {"n0": n_for(r0, n_out, seed)}
    for mode, r in ((16, r16), (32, r32)):
        cls[f"vidx{mode}"] = rng.integers(0, 256, (r, n_out)).astype(np.uint8)
        cls[f"tab{mode}"] = rng.integers(0, 1 << 32, (r, WORDS[mode]),
                                         dtype=np.uint64).astype(np.uint32)
        cls[f"n{mode}"] = n_for(r, n_out, seed + mode)
    return cls


def check_walk(rows, n_out, resident, seed, salts=SALTS):
    """The walk over classes of ``rows`` rows with ``resident`` blocks:
    every lane of the (R0 + R16 + R32, n_out) buffer written once, by
    its own class's body, and the values of ``decode_classes_plain`` in
    both flags and for ``salts``.  Returns (grid, the tiles' rows)."""
    cls = walk_classes(rows, n_out, seed)
    r0, r16, r32 = rows

    def t(name):
        a = cls[name]
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)
    args = (t("n0") if r0 else None,
            (t("vidx16"), t("tab16"), t("n16")) if r16 else None,
            (t("vidx32"), t("tab32"), t("n32")) if r32 else None)
    for salt in salts:
        for exact in (False, True):
            out, writes, owner, grid, tr = walk_mirror(
                cls, rows, n_out, resident, salt, exact)
            assert (writes == 1).all(), (rows, n_out, resident, salt)
            assert (owner[:r0] == 0).all()
            assert (owner[r0 : r0 + r16] == 16).all()
            assert (owner[r0 + r16 :] == 32).all()
            want = t_dl.decode_classes_plain(*args, torch.tensor([salt]),
                                             exact, n_out).numpy()
            np.testing.assert_array_equal(
                out, u32(want), err_msg=f"{rows} {n_out} {salt} {exact}")
    return grid, tr


def test_walk_shape_read_from_the_source():
    """A whole tile's n is 16-byte words (one bulk copy), and a stage's
    parts stay 16-byte aligned at every width."""
    assert WALK_ROWS % 4 == 0 and WALK_STAGES >= 1
    assert WALK_THREADS % 32 == 0
    for n_out in N_OUTS:
        assert all(off % 16 == 0 for off in stage_layout(n_out))
        assert stage_layout(n_out)[-1] <= 232448 // WALK_STAGES


@pytest.mark.parametrize("rows, resident, tile_rows, walks", [
    ((37, 301, 19), 264, 4, False),  # a serving call: the fewest rows
    ((300, 2500, 200), 264, 12, False),  # more rows a tile, one a block
    ((45, 101, 27), 40, 8, False),
    ((15632, 54280, 716), 264, WALK_ROWS, True),  # the bench image: walks
    ((98304, 264192, 40960), 660, WALK_ROWS, True),
])
def test_walk_tile_rows_adapt_to_the_launch(rows, resident, tile_rows,
                                           walks):
    """A launch takes the fewest rows a tile whose tiles the resident
    blocks hold at once, and walks (tiles of WALK_ROWS rows, more than
    the grid) only where even those outnumber the resident blocks, as
    ``decode_classes`` counts it."""
    tr, tiles = walk_of(rows, resident)
    assert tr == min(tile_rows, WALK_ROWS)
    assert (tiles > resident) == walks
    assert walks == (sum(walk_tiles(r) for r in rows) > resident)


@pytest.mark.parametrize("present", ["all", "no_u16", "zero_alone",
                                     "no_zero"])
@pytest.mark.parametrize("n_out", N_OUTS)
def test_fused_partition_writes_each_lane_once(n_out, present):
    """The fused launch (``dint_decode_classes``: the walk over u16 tiles,
    then i32, then zero, a grid of min(tiles, resident blocks)) over
    classes of row counts that are no multiple of a tile, some empty, on
    a card that holds every tile at once, so that each block takes one:
    every lane of the (R0 + R16 + R32, n_out) buffer written once, by
    its own class's body; the values those of ``decode_classes_plain``
    in both flags."""
    per_block = THREADS * ZERO_VEC // (n_out // 4)
    rows = {"zero": 2 * per_block + 3, "u16": 37, "i32": 5}
    if present == "no_u16":
        rows["u16"] = 0
    elif present == "zero_alone":
        rows["u16"] = rows["i32"] = 0
    elif present == "no_zero":
        rows["zero"] = 0
    rows = (rows["zero"], rows["u16"], rows["i32"])
    grid, tr = check_walk(rows, n_out, CARD_RESIDENT, 3)
    assert tr == 4 and grid == sum(walk_tiles(r, 4) for r in rows)


@pytest.mark.parametrize("resident", [1, 3, 40, 132, 264])
@pytest.mark.parametrize("n_out", N_OUTS)
def test_fused_walk_writes_each_lane_once(n_out, resident):
    """The walk with a grid capped below the tile count (a card holding
    ``resident`` blocks at once), so that every block walks several
    tiles of WALK_ROWS rows through its ring of stages, and (40) a grid
    that takes every tile of a middling launch at once: each lane
    written once by its own class's body, every class's last tile short,
    the values those of ``decode_classes_plain`` in both flags."""
    if resident <= 40:
        rows, salts = (45, 101, 27), SALTS
    else:  # more tiles of WALK_ROWS rows than resident blocks
        k = resident * WALK_ROWS // 140
        rows, salts = (20 * k + 3, 130 * k + 5, 10 * k + 1), (0x9E3779B9,)
    assert all(r % 4 for r in rows)
    grid, tr = check_walk(rows, n_out, resident, resident, salts)
    tiles = sum(walk_tiles(r) for r in rows)
    if resident == 40:
        assert tr < WALK_ROWS and grid == walk_of(rows, 40)[1] <= 40
    else:
        assert tr == WALK_ROWS and grid == resident < tiles
