"""X3, the raw DINT decode kernel (``csrc/raw_decode.cu``), on the CPU.

The kernel runs on the card only.  Here a numpy mirror of its algorithm
stands in for the launch: each lane's D x D transition matrix packed
into D * D bits, the 32-lane doubling scan of their products in each
window of a block step, the walk's state carried through the windows'
products from one window and one step to the next, the ballot and warp
prefix of the output lengths with the windows' totals, the slot search
over a window's starts and the tail after ``produced``.  The window
size, the warps a block, the state depth D and the exception steps are
read from the ``.cu`` source.  The mirror must
equal ``decode_units_plain`` (the port's torch ops) and the reference's
``decode_units`` on rows made from a numpy seed: b = 16 and b = 8, clean
and dirty tiles, exceptions that straddle a window edge at every offset,
runs of 16-256 zeros, entries of 16 words, zero-length entries, table
offsets past the table and past 2^31, ``n`` below and above
``produced``, ``w_valid`` 0 and 1 and widths that are no multiple of the
window.  The dispatcher ``decode_units`` runs the plain version on the
CPU, counts no launch, and refuses what the kernel does not take.  Every
comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (x3_edge_tiles, x3_straddle_rows, x3_view,
                        x3_walk_rows)
from dint_tpu.config import EXCEPTIONS, MAX_ENTRY_SIZE
from dint_tpu.kernels import decode_xla as j_dx
from dint_tpu_torch.kernels import decode_xla as t_dx

SRC = os.path.join(os.path.dirname(t_dx.__file__), "csrc", "raw_decode.cu")
TEXT = open(SRC).read()


def constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", TEXT)
    assert m, f"{name} not found in {SRC}"
    return int(m.group(1))


def steps(b):
    """(SMALL, LARGE, D) of ``Steps<b>`` in the source."""
    m = re.search(rf"struct Steps<{b}> {{\s*static constexpr int SMALL = "
                  rf"(\d+), LARGE = (\d+), D = (\d+);", TEXT)
    assert m, f"Steps<{b}> not found in {SRC}"
    return tuple(int(x) for x in m.groups())


WINDOW = constant("WINDOW")
WARPS = constant("WARPS")
STEP = WARPS * WINDOW  # tokens a block step, a window a warp
SLOTS_IN_FLIGHT = constant("SLOTS_IN_FLIGHT")
assert constant("EXCEPTIONS") == EXCEPTIONS
assert constant("MAX_ENTRY_SIZE") == MAX_ENTRY_SIZE


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------


class Mat:
    """``Mat<D>`` of the source: D x D boolean matrices in D * D bits,
    row i at bits [i * D, i * D + D), as int64 numpy arrays."""

    def __init__(self, D):
        self.D = D
        self.ROW = (1 << D) - 1
        self.COL0 = sum(1 << (i * D) for i in range(D))
        self.IDENT = sum(1 << (i * D + i) for i in range(D))
        self.SHIFT = sum(1 << (i * D + i + 1) for i in range(D - 1))

    def compose(self, y, x):
        """R = Y . X: a column of Y spread over its rows, times a row of X
        copied to every row, OR over the columns."""
        r = np.zeros_like(y)
        for k in range(self.D):
            r |= (((y >> k) & self.COL0) * self.ROW) & (
                ((x >> (k * self.D)) & self.ROW) * self.COL0)
        return r

    def apply(self, m, p):
        return sum(int(((m >> (i * self.D)) & self.ROW & p) != 0) << i
                   for i in range(self.D))

    def dense(self, m):
        return np.array([[(m >> (i * self.D + j)) & 1 for j in range(self.D)]
                         for i in range(self.D)], bool)


def shfl_up(x, d):
    """__shfl_up_sync: lane i reads lane i - d (lanes below d their own)."""
    return np.concatenate([x[:d], x[:-d]])


def warp_scan(x, op):
    """The kernel's 5-step inclusive scan over the 32 lanes."""
    lane = np.arange(WINDOW)
    d = 1
    while d < WINDOW:
        o = shfl_up(x, d)
        x = np.where(lane >= d, op(x, o), x)
        d *= 2
    return x


def step_of(c, small, large):
    return 1 if c >= EXCEPTIONS else (large if c == 1 else small)


def mirror_row(tok_row, wv, n, ctx, lengths, offsets, table, b, n_out, clean,
               written):
    """One block of ``raw_decode_kernel`` on one row, step by step of
    WARPS windows: (values (n_out,) u32, produced, consumed).
    ``written`` counts the writes of each slot."""
    small, large, D = steps(b)
    M = Mat(D)
    W = tok_row.shape[0]
    E = lengths.shape[1]
    T = table.shape[0]
    off_c = offsets[ctx].astype(np.int64)
    len_c = lengths[ctx].astype(np.int64)
    w_eff = min(max(wv, 0), W)
    last_j = min(max(n - 1, 0), n_out - 1)
    out = np.zeros(n_out, np.uint32)
    consumed = []

    def token_at(p):
        pc = min(p, W - 1)
        return int(tok_row[pc]) & 0xFFFFFFFF if pc < wv else EXCEPTIONS

    def slot_value(j, q, c, start, off):
        if c >= EXCEPTIONS:
            k = j - start
            if k >= MAX_ENTRY_SIZE:
                return 0
            t = off + k
            if t < 0:
                t += T
            return int(table[min(max(t, 0), T - 1)])
        t1 = token_at(q + 1)
        if b == 16:
            return (t1 | (token_at(q + 2) << 16)) & 0xFFFFFFFF if c == 1 else t1
        t2 = token_at(q + 2)
        if c != 1:
            return t1 | (t2 << 8)
        return (t1 | (t2 << 8) | (token_at(q + 3) << 16)
                | (token_at(q + 4) << 24)) & 0xFFFFFFFF

    def write(j, q, c, start, off):
        v = slot_value(j, q, c, start, off)
        out[j] = v if j < n else 0
        written[j] += 1
        if j == last_j:
            consumed.append(q + step_of(c, small, large))

    last = (0, EXCEPTIONS, 0, int(off_c[min(EXCEPTIONS, E - 1)]))
    pend, out_base = 1, 0
    lane = np.arange(WINDOW)
    for base in range(0, w_eff, STEP):
        # each warp's window: tokens, entries, the scan of its matrices
        wins = []
        for w in range(WARPS):
            q = base + w * WINDOW + lane
            inr = q < w_eff
            tok = np.where(inr, tok_row[np.minimum(q, W - 1)], EXCEPTIONS)
            tok = tok.astype(np.int64)
            dct = tok >= EXCEPTIONS
            e = np.where(dct, np.minimum(tok, E - 1), 0)
            ln = np.where(inr & dct, len_c[e], 1)
            off = np.where(inr & dct, off_c[e], 0)
            before, mat = np.full(WINDOW, M.IDENT, np.int64), None
            if not clean:
                walks = inr & (dct | (tok == 0) | (tok == 1))
                st = np.where(dct, 1, np.where(tok == 1, large, small))
                t = np.where(walks, np.int64(1) << ((st - 1) * D), 0)
                t = t | M.SHIFT
                sc = warp_scan(t.astype(np.int64), M.compose)
                before = shfl_up(sc, 1).copy()
                before[0] = M.IDENT
                mat = int(sc[WINDOW - 1])
            wins.append((q, inr, tok, dct, ln, off, before, mat))
        # the state entering each window, and the next step's
        entry, nxt = [], pend
        for w in range(WARPS):
            entry.append(nxt)
            if not clean:
                nxt = M.apply(wins[w][7], nxt)
        # visited, output lengths, the ballot and the warp prefix
        per = []
        for w, (q, inr, tok, dct, ln, off, before, _) in enumerate(wins):
            vis = inr if clean else inr & ((before & M.ROW & entry[w]) != 0)
            ol = np.where(vis, np.where(dct, ln, 1), 0)
            incl = warp_scan(ol, lambda a, o: a + o)
            vm = int(sum(1 << i for i in range(WINDOW) if vis[i]))
            per.append((vis, ol, incl, vm, bin(vm).count("1")))
        totals = [int(x[2][WINDOW - 1]) for x in per]
        nvis_w = [x[4] for x in per]
        last_w = max([w for w in range(WARPS) if nvis_w[w] > 0], default=-1)
        shs = []
        for w, ((q, _, tok, _, _, off, _, _), (vis, ol, incl, vm, nvis)) in \
                enumerate(zip(wins, per)):
            wbase = out_base + sum(totals[:w])
            sh = [None] * nvis
            for i in range(WINDOW):
                if vis[i]:
                    k = bin(vm & ((1 << i) - 1)).count("1")
                    sh[k] = (int(wbase + incl[i] - ol[i]), int(q[i]),
                             int(tok[i]), int(off[i]))
            shs.append((wbase, sh))
        if last_w >= 0:
            start, cq, cc, co = shs[last_w][1][nvis_w[last_w] - 1]
            last = (cq, cc, start, co)
        for w, (wbase, sh) in enumerate(shs):
            hi = min(wbase + totals[w], n_out)
            for ln0 in range(WINDOW):
                for j0 in range(wbase + ln0, hi, WINDOW * SLOTS_IN_FLIGHT):
                    for u in range(SLOTS_IN_FLIGHT):
                        j = j0 + u * WINDOW
                        if j >= hi:
                            continue
                        lo, up = 0, len(sh)
                        assert sh[0][0] <= j
                        while up - lo > 1:
                            mid = (lo + up) >> 1
                            if sh[mid][0] <= j:
                                lo = mid
                            else:
                                up = mid
                        start, cq, cc, co = sh[lo]
                        write(j, cq, cc, start, co)
        out_base += sum(totals)
        pend = nxt
        if not clean and pend == 0:
            break
    for t0 in range(STEP):  # the tail, spread over the block
        for j in range(max(out_base, 0) + t0, n_out, STEP):
            write(j, last[0], last[1], last[2], last[3])
    assert len(consumed) == 1
    return out, out_base, consumed[0]


def mirror(cw, w_valid, n, ctx, view, b, n_out, clean):
    lengths, offsets, table = view
    offsets = offsets.astype(np.uint32).view(np.int32)
    table = np.asarray(table, np.uint32)
    B = cw.shape[0]
    val = np.zeros((B, n_out), np.uint32)
    produced = np.zeros(B, np.int32)
    consumed = np.zeros(B, np.int32)
    for r in range(B):
        written = np.zeros(n_out, np.int64)
        val[r], produced[r], consumed[r] = mirror_row(
            cw[r], int(w_valid[r]), int(n[r]), int(ctx[r]), lengths, offsets,
            table, b, n_out, clean, written)
        assert (written == 1).all(), r  # every slot written exactly once
    return [val, produced, consumed]


# ---------------------------------------------------------------------------
# inputs: chip_smoke.py's x3_view (every entry length, runs, wrapping and
# clamped table offsets), x3_walk_rows and x3_straddle_rows
# ---------------------------------------------------------------------------


def i32(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=np.int32))


def reference(cw, w_valid, n, ctx, view, b, n_out, clean):
    lengths, offsets, table = view
    out = j_dx.decode_units(
        jnp.asarray(cw), jnp.asarray(w_valid), jnp.asarray(n),
        jnp.asarray(ctx), jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(offsets.astype(np.uint32).view(np.int32)),
        jnp.asarray(table), b=b, n_out=n_out, assume_clean=clean)
    return [np.asarray(out[0]).view(np.uint32), np.asarray(out[1]),
            np.asarray(out[2])]


def plain(cw, w_valid, n, ctx, view, b, n_out, clean):
    lengths, offsets, table = view
    out = t_dx.decode_units_plain(
        i32(cw), i32(w_valid), i32(n), i32(ctx), i32(lengths),
        i32(offsets), i32(table), b=b, n_out=n_out, assume_clean=clean)
    return [out[0].numpy().view(np.uint32), out[1].numpy(), out[2].numpy()]


def check_all(cw, w_valid, n, ctx, view, b, n_out, clean, with_ref=True):
    got = mirror(cw, w_valid, n, ctx, view, b, n_out, clean)
    want = plain(cw, w_valid, n, ctx, view, b, n_out, clean)
    for g, w, what in zip(got, want, ("val", "produced", "consumed")):
        np.testing.assert_array_equal(g, w, err_msg=f"plain {what}")
    if with_ref:
        ref = reference(cw, w_valid, n, ctx, view, b, n_out, clean)
        for g, w, what in zip(got, ref, ("val", "produced", "consumed")):
            np.testing.assert_array_equal(g, w, err_msg=f"reference {what}")
    return got


def n_around(produced, n_out, rng):
    """n for each row: below, at and above produced, 0 and n_out."""
    n = np.empty(produced.shape[0], np.int32)
    for r, p in enumerate(produced):
        n[r] = (p, max(p - int(rng.integers(1, 9)), 0),
                p + int(rng.integers(1, 40)), 0, n_out)[r % 5]
    return np.clip(n, 0, n_out).astype(np.int32)


# ---------------------------------------------------------------------------
# the mirror against the plain version and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [16, 8])
def test_source_constants(b):
    small, large, D = steps(b)
    assert (1, small, large) == t_dx._steps_for(b) == j_dx._steps_for(b)
    assert D == large and WINDOW == 32 and SLOTS_IN_FLIGHT >= 1


@pytest.mark.parametrize("b", [16, 8])
def test_matrix_product_is_the_boolean_product(b):
    """compose() on packed bits equals the boolean matrix product, and
    the forward transition of a codeword sends the walk one token on."""
    _, _, D = steps(b)
    M = Mat(D)
    rng = np.random.default_rng(D)
    y = rng.integers(0, 1 << (D * D), 200)
    x = rng.integers(0, 1 << (D * D), 200)
    r = M.compose(y, x)
    for a, bb, c in zip(y, x, r):
        want = (M.dense(int(a)).astype(int) @ M.dense(int(bb)).astype(int)) > 0
        np.testing.assert_array_equal(M.dense(int(c)), want)
    assert int(M.compose(np.int64(M.IDENT), np.int64(M.SHIFT))) == M.SHIFT
    t_dict = M.SHIFT | 1  # a codeword: bit 0 goes to bit 0 (step 1)
    assert M.apply(t_dict, 1) == 1 and M.apply(M.SHIFT, 1) == 0


@pytest.mark.parametrize("b,W,n_out", [(16, 1, 256), (16, 2, 256),
                                       (16, 45, 256), (16, 1024, 1024),
                                       (8, 1, 256), (8, 3, 256),
                                       (8, 77, 256), (8, 520, 256)])
def test_mirror_dirty_rows(b, W, n_out):
    """Dirty rows (both markers, runs, 16-word and zero-length entries,
    wrapping and clamped table offsets, an exception last, noise past
    w_valid), n below, at and above produced."""
    view = x3_view(seed=W + b)
    B = 11
    cw, w_valid = x3_walk_rows(b, B, W, seed=W * 7 + b)
    w_valid[1] = 0
    w_valid[2] = min(1, W)
    rng = np.random.default_rng(W)
    ctx = rng.integers(0, 2, size=B).astype(np.int32)
    n0 = np.full(B, n_out, np.int32)
    produced = plain(cw, w_valid, n0, ctx, view, b, n_out, False)[1]
    n = n_around(produced, n_out, rng)
    got = check_all(cw, w_valid, n, ctx, view, b, n_out, False)
    assert (got[0] >= 1 << 31).any() or W < 8


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_clean_rows(b):
    """Clean rows (every token in range visited): W = 256 and one that
    is no multiple of the window, w_valid 0, 1 and full."""
    view = x3_view(seed=b + 1)
    rng = np.random.default_rng(b)
    for W in (256, 70):
        cw = rng.integers(EXCEPTIONS, 1 << b, size=(9, W)).astype(np.int32)
        cw[:, ::5] = rng.integers(EXCEPTIONS, 85, size=cw[:, ::5].shape)
        w_valid = rng.integers(0, W + 1, size=9).astype(np.int32)
        w_valid[:3] = (0, 1, W)
        ctx = rng.integers(0, 2, size=9).astype(np.int32)
        n = rng.integers(0, 257, size=9).astype(np.int32)
        check_all(cw, w_valid, n, ctx, view, b, 256, True)


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_exceptions_straddle_every_window_edge(b):
    """An exception whose walk resumes at a window edge plus o, o in
    0..D-1, for both markers and two edges: the carried state has bit o
    set, and the rows decode as the plain version does."""
    view = x3_view(seed=3 * b)
    cw, w_valid = x3_straddle_rows(b)
    _, _, D = steps(b)
    assert cw.shape[1] % WINDOW
    B = cw.shape[0]
    ctx = np.zeros(B, np.int32)
    n = np.full(B, 1024, np.int32)
    check_all(cw, w_valid, n, ctx, view, b, 1024, False)
    # the walk in one straddle row skips exactly the payload tokens
    small, large, _ = steps(b)
    got = t_dx._chain_visited(i32(cw[:1]), b).numpy()[0]
    p = int(np.flatnonzero(cw[0] != 9)[0])
    assert not got[p + 1 : p + small].any() and got[p + small]


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_long_zero_runs_and_entries(b):
    """Rows of run codewords only (16-256 zeros each) and of 16-word
    entries: the slot search spreads a run over every lane, and slots
    past n_out are cut."""
    view = x3_view(seed=11 + b)
    rng = np.random.default_rng(b + 5)
    W = 100
    cw = np.where(rng.random((6, W)) < 0.5,
                  rng.integers(EXCEPTIONS, EXCEPTIONS + 5, (6, W)),
                  rng.integers(7, 40, (6, W))).astype(np.int32)
    w_valid = np.asarray([W, W, 50, 3, 1, 33], np.int32)
    ctx = np.asarray([0, 1, 0, 1, 0, 1], np.int32)
    n = np.asarray([4096, 100, 4000, 300, 256, 8192], np.int32)
    for clean in (True, False):
        got = check_all(cw, w_valid, n, ctx, view, b, 4096, clean)
        assert got[1].max() > 4096  # produced past n_out


def test_mirror_negative_token_stops_the_walk():
    """A visited token that is no codeword nor marker (a negative int32)
    yields one exception-like value and ends the walk: the kernel's
    windows stop early, and still equal the plain version."""
    view = x3_view(seed=2)
    cw = np.full((3, 80), 9, np.int32)
    cw[0, 5] = -3
    cw[1, 40] = -1
    cw[2, 31] = -7
    w_valid = np.asarray([80, 80, 70], np.int32)
    ctx = np.zeros(3, np.int32)
    n = np.asarray([200, 41, 10], np.int32)
    got = check_all(cw, w_valid, n, ctx, view, 16, 256, False,
                    with_ref=False)
    assert got[1][0] < 80 * 17


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_zero_length_entries_give_way(b):
    """Visited zero-length entries share their start with the codeword
    after them: the slot search takes the last start <= j."""
    view = x3_view(seed=4)
    cw = np.asarray([[41, 42, 9, 43, 9, 44, 45],
                     [41, 41, 41, 41, 41, 41, 41],
                     [9, 41, 41, 41, 41, 41, 41]], np.int32)
    w_valid = np.asarray([7, 7, 7], np.int32)
    ctx = np.zeros(3, np.int32)
    n = np.asarray([40, 5, 30], np.int32)
    for clean in (True, False):
        check_all(cw, w_valid, n, ctx, view, b, 256, clean)


def test_mirror_on_the_card_edge_tiles():
    """The edge tiles chip_smoke.py and the card tests hold X3 to on the
    card (b 16 and 8, dirty and clean, W no multiple of 32, w_valid 0 and
    1, exceptions across window and step edges, runs, wrapping table
    offsets): the mirror equals the plain version on each."""
    for label, (cw, wv, n, ctx, ln, off, tab), b, n_out, clean in \
            x3_edge_tiles():
        got = check_all(cw, wv, n, ctx, (ln, off, tab), b, n_out, clean,
                        with_ref=False)
        assert got[0].shape == (cw.shape[0], n_out), label


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def small_tile(b=16):
    view = x3_view(seed=9)
    cw, w_valid = x3_walk_rows(b, 5, 64, seed=9)
    n = np.full(5, 128, np.int32)
    ctx = np.asarray([0, 1, 0, 1, 0], np.int32)
    lengths, offsets, table = view
    return [i32(cw), i32(w_valid), i32(n), i32(ctx), i32(lengths),
            i32(offsets), i32(table)]


@pytest.mark.parametrize("clean", [False, True])
@pytest.mark.parametrize("b", [16, 8])
def test_dispatcher_on_the_cpu_is_the_plain_version(b, clean):
    args = small_tile(b)
    t_dx.reset_launch_counts()
    got = t_dx.decode_units(*args, b=b, n_out=128, assume_clean=clean)
    want = t_dx.decode_units_plain(*args, b=b, n_out=128, assume_clean=clean)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert t_dx.launch_counts() == {"X3_raw_decode": 0}
    assert t_dx.KERNELS == {"X3_raw_decode": t_dx.decode_units}


def test_dispatcher_refuses_what_the_kernel_does_not_take():
    args = small_tile()

    def call(i=None, x=None, **kw):
        a = list(args)
        if i is not None:
            a[i] = x
        opts = dict(b=16, n_out=128)
        opts.update(kw)
        return t_dx.decode_units(*a, **opts)

    with pytest.raises(ValueError, match="b must be 8 or 16"):
        call(b=12)
    with pytest.raises(ValueError, match="n_out"):
        call(n_out=0)
    with pytest.raises(ValueError, match="int32"):
        call(0, args[0].to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        call(6, args[6].to(torch.int16))
    with pytest.raises(ValueError, match=r"cw must be \(B, W\)"):
        call(0, args[0].reshape(-1))
    with pytest.raises(ValueError, match="w_valid must be"):
        call(1, args[1][:3])
    with pytest.raises(ValueError, match="ctx must be"):
        call(3, args[3][None])
    with pytest.raises(ValueError, match="lengths and offsets"):
        call(5, args[5][:, :100])
    with pytest.raises(ValueError, match="table must be"):
        call(6, args[6][:0])
    with pytest.raises(ValueError, match="contiguous"):
        call(0, args[0].t().contiguous().t())
    with pytest.raises(ValueError, match="int32 on cpu"):
        call(4, args[4].to("meta"))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        t_dx.decode_units(*meta, b=16, n_out=128)
