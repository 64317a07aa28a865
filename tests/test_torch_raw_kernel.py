"""X3, the raw DINT decode kernel (``csrc/raw_decode.cu``), on the CPU.

The kernel runs on the card only.  Here a numpy mirror of its algorithm
stands in for the launch: the row table and items of ``plan_rows`` (a
row a warp or a block, longest first), and for each row its team's
rounds: every thread's run of tokens composed into one D x D boolean
matrix packed in D * D bits (``push``), the warp scan of the products by
shuffles and, in a block, the pass over the warps' products, the state
carried from one chunk to the next, each run walked again from its state
to mark the visited tokens, the team's exclusive sums of codewords and
output lengths, the codeword lists, the slots a window at a time (each
inner codeword's mark at its first slot, the scan of the 32-slot groups'
last marks, each slot's codeword from a ballot of its group's marks or
the group's carry) and the tail after ``produced``.  The team size, the
run, the window, the kind bits and the exception steps are read from the
``.cu`` source.  The mirror must equal ``decode_units_plain`` (the port's torch
ops) and the reference's ``decode_units`` on rows made from a numpy
seed, with each row taken by a warp and by a block: b = 16 and b = 8,
clean and dirty, exceptions that straddle a run, warp or chunk edge at
every offset, runs of 16-256 zeros, entries of 16 words, zero-length
entries, table offsets past the table, past 2^31 and just below it (the
index sums in wrapping int32), ``n`` below and above ``produced``,
``w_valid`` 0 and 1 and widths that are no multiple of 32.  The row
table's order, offsets and views, and the dispatcher's refusals, are
checked too.  Every comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (X3_EDGES, x3_edge_pass, x3_edge_tiles,
                        x3_straddle_rows, x3_view, x3_walk_rows)
from dint_tpu.config import EXCEPTIONS, MAX_ENTRY_SIZE
from dint_tpu.kernels import decode_xla as j_dx
from dint_tpu_torch.kernels import decode_xla as t_dx

SRC = os.path.join(os.path.dirname(t_dx.__file__), "csrc", "raw_decode.cu")
TEXT = open(SRC).read()
MASK = 0xFFFFFFFF


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


THREADS = constant("THREADS")
WARP = constant("WARP")
RUN = constant("RUN")
WARP_RUN = constant("WARP_RUN")
STAGE = constant("STAGE")
assert "constexpr int WARP_STAGE = STAGE / WARPS;" in TEXT
WARP_STAGE = STAGE // (THREADS // WARP)
KIND_SHIFT = constant("KIND_SHIFT")
assert constant("EXCEPTIONS") == EXCEPTIONS
assert constant("MAX_ENTRY_SIZE") == MAX_ENTRY_SIZE
DICT, SMALL_EXC, LARGE_EXC = 0, 1, 2


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

    def compose(self, y, x):
        """R = Y . X: a column of Y spread over its rows, times a row of X
        copied to every row, OR over the columns."""
        r = np.zeros(np.broadcast(y, x).shape, np.int64)
        for k in range(self.D):
            r |= (((y >> k) & self.COL0) * self.ROW) & (
                ((x >> (k * self.D)) & self.ROW) * self.COL0)
        return r

    def push(self, p, walks, step):
        """T_q . P: rows shift down one; a walking token's row step - 1
        also takes row 0."""
        return (p >> self.D) | np.where(
            walks, (p & self.ROW) << ((step - 1) * self.D), 0)

    def apply(self, m, p):
        """M . p, elementwise over arrays of matrices and states."""
        r = np.zeros(np.broadcast(m, p).shape, np.int64)
        for i in range(self.D):
            r |= (((m >> (i * self.D)) & self.ROW & p) != 0).astype(
                np.int64) << i
        return r

    def dense(self, m):
        return np.array([[(m >> (i * self.D + j)) & 1 for j in range(self.D)]
                         for i in range(self.D)], bool)


def shfl_up(x, d):
    """__shfl_up_sync along the last axis (lanes): lane i reads lane
    i - d, lanes below d their own."""
    return np.concatenate([x[..., :d], x[..., :-d]], axis=-1)


def warp_scan(x, op):
    """The kernel's 5-step inclusive scan over each warp's 32 lanes (x:
    (warps, 32))."""
    lane = np.arange(WARP)
    d = 1
    while d < WARP:
        x = np.where(lane >= d, op(x, shfl_up(x, d)), x)
        d *= 2
    return x


def kind_of(c):
    return np.where(c >= EXCEPTIONS, DICT, np.where(c == 1, LARGE_EXC,
                                                    SMALL_EXC))


def step_of(kind, b):
    small, large, _ = steps(b)
    return np.where(kind == DICT, 1, np.where(kind == LARGE_EXC, large,
                                              small))


def last_le(s, x):
    """The kernel's ``last_le``: the last k with s[k] <= x (s[0] <= x)."""
    lo, up = 0, s.shape[0]
    while up - lo > 1:
        mid = (lo + up) >> 1
        if s[mid] <= x:
            lo = mid
        else:
            up = mid
    return lo


def wrap32(x):
    """An integer as the kernel's int of its low 32 bits."""
    x = int(x) & MASK
    return x - (1 << 32) if x >= 1 << 31 else x


class RowMirror:
    """``decode_row<BITS, CLEAN, TEAM>`` on one row: writes its slots of
    ``val`` (and counts each write in ``written``), its produced and its
    consumed."""

    def __init__(self, tok_row, wv, n, ctx, view, b, n_out, clean, team):
        self.tok_row, self.wv, self.n = tok_row, int(wv), int(n)
        self.b, self.n_out, self.clean, self.team = b, n_out, clean, team
        lengths, offsets, table = view
        self.len_c = lengths[ctx].astype(np.int64)
        self.off_c = offsets.view(np.int32)[ctx].astype(np.int64)
        self.table = table
        self.W = tok_row.shape[0]
        self.E = lengths.shape[1]
        self.T = table.shape[0]

    def token_at(self, p):
        pc = np.minimum(p, self.W - 1)
        return np.where(pc < self.wv, self.tok_row[pc].astype(np.int64) & MASK,
                        EXCEPTIONS)

    def slot_values(self, j, q, kind, start, off):
        """slot_value<BITS> over arrays of slots and their codewords."""
        k = j - start
        t = (off + np.minimum(k, MAX_ENTRY_SIZE - 1)) & MASK
        t = np.where(t >= 1 << 31, t - (1 << 32), t)  # wrapping int32 sum
        t = np.where(t < 0, t + self.T, t).clip(0, self.T - 1)
        dval = np.where(k < MAX_ENTRY_SIZE, self.table[t].astype(np.int64),
                        0)
        t1, t2 = self.token_at(q + 1), self.token_at(q + 2)
        if self.b == 16:
            small = t1
            large = t1 | (t2 << 16)
        else:
            small = t1 | (t2 << 8)
            large = (t1 | (t2 << 8) | (self.token_at(q + 3) << 16)
                     | (self.token_at(q + 4) << 24))
        exc = np.where(kind == LARGE_EXC, large, small)
        return np.where(kind == DICT, dval, exc) & MASK

    def write(self, val, written, j, q, kind, start, off):
        v = self.slot_values(j, q, kind, start, off)
        val[j] = np.where(j < self.n, v, 0)
        np.add.at(written, j, 1)
        last_j = min(max(self.n - 1, 0), self.n_out - 1)
        hit = np.flatnonzero(j == last_j)
        if hit.size:
            self.consumed.append(int(q[hit[0]] + step_of(kind[hit[0]],
                                                         self.b)))

    def run(self, val, written):
        b, team, clean = self.b, self.team, self.clean
        M = Mat(steps(b)[2])
        run = WARP_RUN if team == WARP else RUN
        chunk = team * run
        w_eff = min(max(self.wv, 0), self.W)
        t = np.arange(team)
        warp = t // WARP
        i_run = np.arange(run)
        self.consumed = []
        last = (0, DICT, 0, int(self.off_c[min(EXCEPTIONS, self.E - 1)]))
        pend, out_base = 1, 0
        for base in range(0, w_eff, chunk):
            q = base + t[:, None] * run + i_run[None, :]  # (team, run)
            inr = q < w_eff
            tok = np.where(inr, self.tok_row[np.minimum(q, self.W - 1)],
                           EXCEPTIONS).astype(np.int64)
            dct = inr & (tok >= EXCEPTIONS)
            e = np.where(dct, np.minimum(tok, self.E - 1), 0)
            ln = np.where(dct, self.len_c[e], 1)
            off = np.where(dct, self.off_c[e], 0)
            kind = kind_of(tok)
            st = step_of(kind, b)
            walks = inr & ((tok >= EXCEPTIONS) | (tok == 0) | (tok == 1))
            s, pend_next = np.full(team, pend, np.int64), pend
            if not clean:
                p = np.full(team, M.IDENT, np.int64)
                for i in range(run):
                    p = M.push(p, walks[:, i], st[:, i])
                p = warp_scan(p.reshape(-1, WARP), M.compose)
                before = shfl_up(p, 1)
                before[:, 0] = M.IDENT
                entry = []
                for w in range(team // WARP):  # the warps' products in turn
                    entry.append(pend_next)
                    pend_next = int(M.apply(p[w, WARP - 1], pend_next))
                s = M.apply(before.reshape(-1), np.asarray(entry)[warp])
            vis = np.zeros((team, run), bool)
            for i in range(run):
                v = inr[:, i] & (clean | ((s & 1) != 0))
                if not clean:
                    s = (s >> 1) | np.where(v & walks[:, i],
                                            1 << (st[:, i] - 1), 0)
                vis[:, i] = v
            cnt = vis.sum(1)
            lsum = np.where(vis, ln, 0).sum(1) & MASK
            c_in = warp_scan(cnt.reshape(-1, WARP), np.add).reshape(-1)
            l_in = warp_scan(lsum.reshape(-1, WARP),
                             lambda x, o: (x + o) & MASK).reshape(-1)
            wc = c_in.reshape(-1, WARP)[:, -1]
            wl = l_in.reshape(-1, WARP)[:, -1]
            k0 = c_in - cnt + np.concatenate([[0], np.cumsum(wc)[:-1]])[warp]
            s0 = (out_base + l_in - lsum
                  + np.concatenate([[0], np.cumsum(wl)[:-1]])[warp]) & MASK
            nvis, total = int(wc.sum()), int(wl.sum()) & MASK
            starts = np.zeros(nvis, np.int64)
            qk = np.zeros(nvis, np.int64)
            offs = np.zeros(nvis, np.int64)
            for th in range(team):  # each thread writes its codewords
                k, sa = int(k0[th]), int(s0[th])
                for i in range(run):
                    if vis[th, i]:
                        starts[k] = wrap32(sa)
                        qk[k] = int(q[th, i]) | (int(kind[th, i])
                                                 << KIND_SHIFT)
                        offs[k] = off[th, i]
                        k += 1
                        sa += int(ln[th, i])
            assert (np.diff(starts) >= 0).all()
            if nvis:
                last = (int(qk[-1]) & ((1 << KIND_SHIFT) - 1),
                        int(qk[-1]) >> KIND_SHIFT, int(starts[-1]),
                        int(offs[-1]))
            end = wrap32(out_base + total)
            hi = min(end, self.n_out)
            last_j = min(max(self.n - 1, 0), self.n_out - 1)
            ws = WARP_STAGE if team == WARP else STAGE
            lane = np.arange(WARP)
            for w0 in range(out_base, hi, ws):  # the windows
                nw = min(ws, hi - w0)
                k0 = last_le(starts, w0)
                k1 = last_le(starts, w0 + nw - 1)
                # marks: k + 1 at each inner codeword's first slot (the
                # last at one slot wins), each group's last mark
                mark = np.zeros(ws, np.int64)
                gmax = np.zeros(ws // WARP, np.int64)
                ks = np.arange(k0 + 1, k1 + 1)
                assert ((starts[ks] > w0) & (starts[ks] < w0 + nw)).all()
                np.maximum.at(mark, starts[ks] - w0, ks + 1)
                np.maximum.at(gmax, (starts[ks] - w0) // WARP, ks + 1)
                # one warp's scan of the groups' last marks: PER groups a
                # lane, an exclusive max over the lanes, k0 + 1 first
                per = -(-gmax.shape[0] // WARP)
                held = np.zeros((WARP, per), np.int64)
                g_of = lane[:, None] * per + np.arange(per)[None, :]
                ok = g_of < gmax.shape[0]
                held[ok] = gmax[g_of[ok]]
                upto = warp_scan(held.max(1)[None, :], np.maximum)[0]
                carry = np.maximum(shfl_up(upto, 1), k0 + 1)
                carry[0] = k0 + 1
                gpre = np.zeros(gmax.shape[0], np.int64)
                for p in range(per):
                    gpre[g_of[ok[:, p], p]] = carry[ok[:, p]]
                    carry = np.maximum(carry, held[:, p])
                # a group a warp, a slot a lane: the highest mark at or below
                # the lane (ballot, shuffle), or the group's carry
                groups = -(-nw // WARP)
                m = mark[: groups * WARP].reshape(groups, WARP)
                ballot = ((m != 0).astype(np.int64) << lane).sum(1)
                below = ballot[:, None] & ((2 << lane) - 1)[None, :] & MASK
                top = np.frexp(below.astype(np.float64))[1] - 1
                src = np.where(below != 0, top, lane[None, :])
                mk = np.take_along_axis(m, src, 1)
                k = (np.where(below != 0, mk, gpre[:groups, None]) - 1)
                k = k.reshape(-1)[:nw]
                assert (k >= k0).all() and (k <= k1).all()
                self.write(val, written, w0 + np.arange(nw),
                           qk[k] & ((1 << KIND_SHIFT) - 1),
                           qk[k] >> KIND_SHIFT, starts[k], offs[k])
            out_base = end
            pend = pend_next
            if not clean and pend == 0:
                break
        j = np.arange(max(out_base, 0), self.n_out, dtype=np.int64)
        if j.size:
            self.write(val, written, j, *(np.full(j.shape, x, np.int64)
                                          for x in last))
        assert len(self.consumed) == 1
        return out_base, self.consumed[0]


def mirror(cw, w_valid, n, ctx, view, b, n_out, clean, team):
    """Every row of a tile by a team of ``team`` threads."""
    B = cw.shape[0]
    val = np.zeros((B, n_out), np.int64)
    produced = np.zeros(B, np.int32)
    consumed = np.zeros(B, np.int32)
    for r in range(B):
        written = np.zeros(n_out, np.int64)
        produced[r], consumed[r] = RowMirror(
            cw[r], w_valid[r], n[r], ctx[r], view, b, n_out, clean,
            team).run(val[r], written)
        assert (written == 1).all(), r  # every slot written exactly once
    return [val.astype(np.uint32), produced, consumed]


def mirror_pass(tiles, view, warp_tokens=t_dx.X3_WARP_ROW_TOKENS):
    """The kernel over the row table of ``plan_rows`` (rows of at most
    ``warp_tokens`` tokens in range a warp): every item in launch order,
    its rows by a warp or by the block, into one buffer; returns each
    tile's (val, produced, consumed) read back through the tiles'
    offsets."""
    specs, row0, tok0, out0 = [], 0, 0, 0
    for cw, _, _, _, b, N, clean in tiles:
        specs.append(t_dx.TileSpec(b, clean, cw.shape[1], N, cw.shape[0],
                                   row0, tok0, out0))
        row0 += cw.shape[0]
        tok0 += cw.size
        out0 += cw.shape[0] * N
    flat = [np.concatenate([np.asarray(t[k]).reshape(-1) for t in tiles])
            for k in range(4)]
    rows, items = t_dx.plan_rows(specs, *flat[1:], warp_tokens=warp_tokens)
    val = np.zeros(out0, np.int64)
    written = np.zeros(out0, np.int64)
    produced = np.full(row0, -7, np.int64)
    consumed = np.full(row0, -7, np.int64)
    for group, warp_rows, r0, nrows in items:
        b, clean = (8 if group & 1 else 16), bool(group & 2)
        for rd in rows[r0 : r0 + nrows]:
            tok = flat[0][rd["tok"] : rd["tok"] + rd["W"]]
            sl = slice(rd["out"], rd["out"] + rd["n_out"])
            produced[rd["idx"]], consumed[rd["idx"]] = RowMirror(
                tok, rd["wv"], rd["n"], rd["ctx"], view, b, rd["n_out"],
                clean, WARP if warp_rows else THREADS).run(val[sl],
                                                           written[sl])
    assert (written == 1).all() and (produced != -7).all()
    return [[val[s.out0 : s.out0 + s.rows * s.N].reshape(s.rows, s.N)
             .astype(np.uint32), produced[s.row0 : s.row0 + s.rows],
             consumed[s.row0 : s.row0 + s.rows]] for s in specs]


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


def assert_same(got, want, what):
    for g, w, part in zip(got, want, ("val", "produced", "consumed")):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {part}")


def check_all(cw, w_valid, n, ctx, view, b, n_out, clean, with_ref=True):
    """The mirror with a warp a row and with a block a row, against the
    plain version and (``with_ref``) the reference."""
    want = plain(cw, w_valid, n, ctx, view, b, n_out, clean)
    if with_ref:
        assert_same(want, reference(cw, w_valid, n, ctx, view, b, n_out,
                                    clean), "plain against reference")
    for team in (WARP, THREADS):
        got = mirror(cw, w_valid, n, ctx, view, b, n_out, clean, team)
        assert_same(got, want, f"team {team}")
    return want


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
    assert D == large and WARP == 32 and THREADS % WARP == 0
    assert (THREADS, WARP, RUN, WARP_RUN) == (
        t_dx.X3_THREADS, t_dx.X3_WARP, t_dx.X3_RUN, t_dx.X3_WARP_RUN)
    assert THREADS * RUN >= THREADS * WARP_RUN  # the lists hold a warp row
    assert "constexpr int GROUPS = STAGE / WARP;" in TEXT
    assert WARP_STAGE % WARP == 0
    assert t_dx.X3_MAX_W == 1 << KIND_SHIFT
    assert t_dx.ROW_DTYPE.itemsize == 40  # RowDesc


@pytest.mark.parametrize("b", [16, 8])
def test_matrix_product_is_the_boolean_product(b):
    """compose() on packed bits equals the boolean matrix product, push()
    equals composing with a token's transition, and a codeword's
    transition sends the walk one token on."""
    _, large, D = steps(b)
    M = Mat(D)
    rng = np.random.default_rng(D)
    y = rng.integers(0, 1 << (D * D), 200)
    x = rng.integers(0, 1 << (D * D), 200)
    r = M.compose(y, x)
    for a, bb, c in zip(y, x, r):
        want = (M.dense(int(a)).astype(int) @ M.dense(int(bb)).astype(int)) > 0
        np.testing.assert_array_equal(M.dense(int(c)), want)
    shift = sum(1 << (i * D + i + 1) for i in range(D - 1))
    for step in range(1, large + 1):
        for walks in (False, True):
            t = shift | ((1 << ((step - 1) * D)) if walks else 0)
            np.testing.assert_array_equal(M.push(x, walks, step),
                                          M.compose(np.int64(t), x))
    assert int(M.apply(M.push(np.int64(M.IDENT), True, 1), 1)) == 1
    assert int(M.apply(M.push(np.int64(M.IDENT), False, 1), 1)) == 0


@pytest.mark.parametrize("b,W,n_out", [(16, 1, 256), (16, 2, 256),
                                       (16, 45, 256), (16, 1024, 1024),
                                       (16, 2500, 1024), (8, 1, 256),
                                       (8, 3, 256), (8, 77, 256),
                                       (8, 520, 256), (8, 2100, 256)])
def test_mirror_dirty_rows(b, W, n_out):
    """Dirty rows (both markers, runs, 16-word and zero-length entries,
    wrapping and clamped table offsets, an exception last, noise past
    w_valid), n below, at and above produced; rows past a block's chunk
    at the widest (held to the plain version only: the reference's scan
    compiles for a minute at that width, and the plain version is held
    to it at W = 1024 in tests/test_torch_raw_decode.py)."""
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
    got = check_all(cw, w_valid, n, ctx, view, b, n_out, False,
                    with_ref=W <= 1024)
    assert (got[0] >= 1 << 31).any() or W < 8


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_clean_rows(b):
    """Clean rows (every token in range visited): W = 256, one that is no
    multiple of 32 and one past a block's chunk, w_valid 0, 1 and full."""
    view = x3_view(seed=b + 1)
    rng = np.random.default_rng(b)
    for W, n_out in ((256, 256), (70, 256), (2300, 4096)):
        cw = rng.integers(EXCEPTIONS, 1 << b, size=(9, W)).astype(np.int32)
        cw[:, ::5] = rng.integers(EXCEPTIONS, 90, size=cw[:, ::5].shape)
        w_valid = rng.integers(0, W + 1, size=9).astype(np.int32)
        w_valid[:3] = (0, 1, W)
        ctx = rng.integers(0, 2, size=9).astype(np.int32)
        n = rng.integers(0, n_out + 1, size=9).astype(np.int32)
        check_all(cw, w_valid, n, ctx, view, b, n_out, True)


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_exceptions_straddle_every_window_edge(b):
    """An exception whose walk resumes at an edge plus o, o in 0..D-1, for
    both markers, at a thread's run, at a warp row's chunk, between the
    warps of a block row, at a block row's chunk and two: the carried
    state has bit o set, and the rows decode as the plain version does.
    The rows at the first three edges (W = 205) are held to the reference
    as well; those at a block row's chunk and two (W = 2053) to the plain
    version only, since the reference's scan compiles for a minute at
    that width."""
    view = x3_view(seed=3 * b)
    assert {RUN, WARP * WARP_RUN, WARP * RUN, THREADS * RUN} <= set(X3_EDGES)
    for W, edges, with_ref in ((205, X3_EDGES[:3], True),
                               (2053, X3_EDGES[3:], False)):
        cw, w_valid = x3_straddle_rows(b, W, edges)
        assert cw.shape[1] % WARP
        B = cw.shape[0]
        ctx = np.zeros(B, np.int32)
        n = np.full(B, 1024, np.int32)
        check_all(cw, w_valid, n, ctx, view, b, 1024, False,
                  with_ref=with_ref)
    # the walk in one straddle row skips exactly the payload tokens
    small, large, _ = steps(b)
    got = t_dx._chain_visited(i32(cw[:1]), b).numpy()[0]
    p = int(np.flatnonzero(cw[0] != 9)[0])
    assert not got[p + 1 : p + small].any() and got[p + small]


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_long_zero_runs_and_entries(b):
    """Rows of run codewords only (16-256 zeros each) and of 16-word
    entries: a run spreads over the lanes and spans groups and windows,
    and slots past n_out are cut."""
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
    chunks stop early, and still equal the plain version."""
    view = x3_view(seed=2)
    cw = np.full((4, 2100), 9, np.int32)
    cw[0, 5] = -3
    cw[1, 40] = -1
    cw[2, 31] = -7
    cw[3, 2050] = -2
    w_valid = np.asarray([80, 80, 70, 2100], np.int32)
    ctx = np.zeros(4, np.int32)
    n = np.asarray([200, 41, 10, 4096], np.int32)
    got = check_all(cw, w_valid, n, ctx, view, 16, 4096, False,
                    with_ref=False)
    assert got[1][0] < 80 * 17


@pytest.mark.parametrize("b", [16, 8])
def test_mirror_zero_length_entries_give_way(b):
    """Visited zero-length entries share their start with the codeword
    after them: their marks lose to the codeword after them at one slot,
    and the window's search of the starts takes the last start <= j."""
    view = x3_view(seed=4)
    cw = np.asarray([[41, 42, 9, 43, 9, 44, 45],
                     [41, 41, 41, 41, 41, 41, 41],
                     [9, 41, 41, 41, 41, 41, 41]], np.int32)
    w_valid = np.asarray([7, 7, 7], np.int32)
    ctx = np.zeros(3, np.int32)
    n = np.asarray([40, 5, 30], np.int32)
    for clean in (True, False):
        check_all(cw, w_valid, n, ctx, view, b, 256, clean)


@pytest.mark.parametrize("b", [16, 8])
def test_table_index_sums_in_wrapping_int32(b):
    """An entry whose offset lies just below 2^31: offset + k wraps to a
    negative int32 in the plain version and the reference (then wraps by
    T and is clamped to 0), where a 64-bit sum would clamp to T - 1.  The
    mirror sums as the kernel does, in wrapping int32."""
    lengths, offsets, table = view = x3_view(seed=8)
    assert offsets[0, 85] > (1 << 31) - 16 and lengths[0, 85] == 16
    cw = np.full((1, 4), 85, np.int32)
    for clean in (True, False):
        got = check_all(cw, np.asarray([4], np.int32),
                        np.asarray([64], np.int32), np.zeros(1, np.int32),
                        view, b, 256, clean)
        k = (1 << 31) - int(offsets[0, 85])  # the first k that wraps
        assert got[0][0, k] == table[0] != table[-1]


def test_mirror_on_the_card_edge_tiles():
    """The edge tiles the card holds X3 to (b 16 and 8, dirty and clean,
    rows a warp and rows a block take), mirrored as one mixed pass through
    ``plan_rows``' row table: each tile equal to the plain version on that
    tile alone."""
    cases = x3_edge_tiles()
    tiles = [(cw, wv, n, ctx, b, n_out, clean)
             for _, (cw, wv, n, ctx, *_d), b, n_out, clean in cases]
    view = cases[0][1][4:]
    got = mirror_pass(tiles, view)
    for (label, args, b, n_out, clean), g in zip(cases, got):
        assert_same(g, plain(*args[:4], view, b, n_out, clean), label)
    _, pt = x3_edge_pass("cpu")
    teams = {int(w) for w in pt.items[:, 1]}
    assert teams == {0, 1} and {int(g) for g in pt.items[:, 0]} == {0, 1, 2,
                                                                    3}


# ---------------------------------------------------------------------------
# the row table and the pass entry
# ---------------------------------------------------------------------------


def random_tiles(seed, count=9):
    """Host tiles of both widths and both kinds, short and long rows."""
    rng = np.random.default_rng(seed)
    tiles = []
    for i in range(count):
        b, clean = (16, 8)[i % 2], bool(i % 3 == 0)
        W = int(rng.choice([64, 256, 1500, 3000]))
        N = int(rng.choice([256, 1024, 4096]))
        rows = int(rng.integers(1, 20))
        cw = rng.integers(EXCEPTIONS, 90, size=(rows, W)).astype(np.int32)
        wv = rng.integers(0, W + 1, rows).astype(np.int32)
        n = rng.integers(0, N + 1, rows).astype(np.int32)
        ctx = rng.integers(0, 2, rows).astype(np.int32)
        tiles.append((cw, wv, n, ctx, b, N, clean))
    return tiles


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_row_table_order_offsets_and_items(seed):
    """plan_rows: every row once, at its tile's token and slot offsets with
    its own w_valid, n, ctx and index; items of one group, a block's row
    too long for a warp or up to WARPS rows a warp can take; items by
    their rounds of work, most first."""
    tiles = random_tiles(seed)
    view = x3_view(seed=seed)
    pt = t_dx.pass_table(tiles, *(i32(a) for a in view))
    rows, items = pt.rows, pt.items
    assert sorted(rows["idx"].tolist()) == list(range(pt.R))
    assert items[:, 3].sum() == pt.R
    assert (items[:, 2] == np.concatenate([[0], np.cumsum(items[:, 3])[:-1]])
            ).all()
    for s, (cw, wv, n, ctx, b, N, clean) in zip(pt.specs, tiles):
        for r in range(s.rows):
            rd = rows[rows["idx"] == s.row0 + r][0]
            assert (rd["tok"], rd["out"], rd["W"], rd["n_out"]) == (
                s.tok0 + r * s.W, s.out0 + r * N, cw.shape[1], N)
            assert (rd["wv"], rd["n"], rd["ctx"]) == (wv[r], n[r], ctx[r])
    group_of = np.concatenate([[t_dx.row_group(t[4], t[6])] * t[0].shape[0]
                               for t in tiles])
    w_eff = np.clip(rows["wv"], 0, rows["W"])
    short = ((w_eff <= t_dx.X3_WARP_ROW_TOKENS)
             & (rows["n_out"] <= t_dx.X3_WARP_ROW_SLOTS))
    cost = []
    for g, warp_rows, r0, n in items:
        mine = rows[r0 : r0 + n]
        assert (group_of[mine["idx"]] == g).all()
        if warp_rows:
            assert 1 <= n <= THREADS // WARP and short[r0 : r0 + n].all()
        else:
            assert n == 1 and not short[r0]
        team = WARP if warp_rows else THREADS
        c = t_dx.row_cost(np.clip(mine["wv"], 0, mine["W"]), mine["n_out"],
                          bool(g & 2), team)
        cost.append(int(c.max()))
    assert cost == sorted(cost, reverse=True)


@pytest.mark.parametrize("warp_tokens", [0, 256, 512])
def test_mirror_pass_at_other_warp_cutoffs(warp_tokens):
    """Rows planned with warps only up to ``warp_tokens`` tokens in range
    (0: only rows with none): a row takes a warp exactly when it is that
    short, and the pass decodes as the plain version does."""
    tiles = random_tiles(20 + warp_tokens, count=4)
    view = x3_view(seed=5)
    pt = t_dx.pass_table(tiles, *(i32(a) for a in view), warp_tokens)
    rows, items = pt.rows, pt.items
    short = ((np.clip(rows["wv"], 0, rows["W"]) <= warp_tokens)
             & (rows["n_out"] <= t_dx.X3_WARP_ROW_SLOTS))
    for _, warp_rows, r0, n in items:
        assert (short[r0 : r0 + n] == bool(warp_rows)).all()
    assert set(items[:, 1].tolist()) == ({0, 1} if warp_tokens else {0})
    got = mirror_pass(tiles, view, warp_tokens)
    for (cw, wv, n, ctx, b, N, clean), g in zip(tiles, got):
        assert_same(g, plain(cw, wv, n, ctx, view, b, N, clean),
                    f"b {b} clean {clean} W {cw.shape[1]}")


def test_pass_table_views_and_outputs():
    """A pass table's tiles are views of its flat tensors; a pass's
    outputs (``PassOutputs``) are views of its one buffer at each tile's
    slot, produced and consumed offsets; on the CPU ``decode_pass`` is
    ``decode_pass_plain``."""
    tiles = random_tiles(4, count=5)
    view = x3_view(seed=4)
    pt = t_dx.pass_table(tiles, *(i32(a) for a in view))
    for i, (cw, wv, n, ctx, *_rest) in enumerate(tiles):
        got = pt.tile(i)
        for g, w in zip(got, (cw, wv, n, ctx)):
            np.testing.assert_array_equal(g.numpy(), w)
            assert g.untyped_storage().data_ptr() in {
                x.untyped_storage().data_ptr()
                for x in (pt.tokens, pt.w_valid, pt.n, pt.ctx)}
    buf = torch.arange(pt.slots + 2 * pt.R, dtype=torch.int32)
    outs = t_dx.PassOutputs(pt, buf)
    assert len(outs) == len(tiles) and len(outs[1:3]) == 2
    for s, (out, produced, consumed) in zip(pt.specs, outs):
        assert out.shape == (s.rows, s.N)
        assert int(out[0, 0]) == s.out0
        assert int(produced[0]) == pt.slots + s.row0
        assert int(consumed[0]) == pt.slots + pt.R + s.row0
    assert outs[-1][0].data_ptr() == outs[len(tiles) - 1][0].data_ptr()
    t_dx.reset_launch_counts()
    for g, w in zip(t_dx.decode_pass(pt), t_dx.decode_pass_plain(pt)):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert t_dx.launch_counts() == {"X3_raw_decode": 0}


def test_pass_table_refuses_what_the_kernel_does_not_take():
    tiles = random_tiles(5, count=3)
    view = [i32(a) for a in x3_view(seed=5)]
    bad_ctx = [list(t) for t in tiles]
    bad_ctx[1][3] = np.full_like(bad_ctx[1][3], 2)
    with pytest.raises(ValueError, match=r"ctx must lie in \[0, 2\)"):
        t_dx.pass_table([tuple(t) for t in bad_ctx], *view)
    bad_b = [list(t) for t in tiles]
    bad_b[0][4] = 12
    with pytest.raises(ValueError, match="b must be 8 or 16"):
        t_dx.pass_table([tuple(t) for t in bad_b], *view)
    with pytest.raises(ValueError, match="lengths and offsets"):
        t_dx.pass_table(tiles, view[0][:, :2], view[1][:, :2], view[2])
    with pytest.raises(ValueError, match="int32"):
        t_dx.pass_table(tiles, view[0], view[1], view[2].to(torch.int64))
    pt = t_dx.pass_table(tiles, *view)
    with pytest.raises(ValueError, match="w_valid must be"):
        t_dx.PassTable(pt.tokens, pt.w_valid[1:], pt.n, pt.ctx, pt.specs,
                       *view)
    with pytest.raises(ValueError, match="past the token buffer"):
        t_dx.PassTable(pt.tokens[:-1], pt.w_valid, pt.n, pt.ctx, pt.specs,
                       *view)
    with pytest.raises(ValueError, match="unsupported device"):
        t_dx.PassTable(pt.tokens.to("meta"), pt.w_valid, pt.n, pt.ctx,
                       pt.specs, *view)


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
    assert t_dx.KERNELS == {"X3_raw_decode": t_dx.decode_pass}


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
    with pytest.raises(ValueError, match=r"ctx must lie in \[0, 2\)"):
        call(3, args[3] + 2)
    with pytest.raises(ValueError, match=r"ctx must lie in \[0, 2\)"):
        call(3, args[3] - 1)
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
