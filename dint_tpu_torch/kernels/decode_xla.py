"""Batched DINT decode of the raw chain-scan engine: X3, one hand kernel
launch a pass over every tile on the card (``csrc/raw_decode.cu``), and
its plain version in PyTorch ops.

The reference decode (vroom_env/dint_codecs.hpp:37-107) is a sequential
pointer walk: read a codeword, copy a dictionary entry or consume an
inline exception, advance a data-dependent number of stream words.
Here it runs as three dense phases over a whole batch of encoded units
(lists or 256-int blocks) at once, as in the reference package's
``kernels/decode_xla.py``:

1. **Classify**: view each unit's byte range as a token stream
   (u16 for b=16, u8 for b=8) and compute, for every token position,
   its step (1 token for a dictionary codeword, 1+2/tw for a 2-byte
   exception, 1+4/tw for a 4-byte one) and output length.

2. **Chain**: the walk visits positions 0, f(0), f(f(0)), ... where
   f(q) = q + step(q).  Steps are bounded (<= 3 token widths for b=16,
   <= 5 for b=8), so visited-ness is a short linear recurrence over the
   boolean semiring, solved for all positions at once by a log-step
   (Hillis-Steele) inclusive scan over per-position D x D transition
   matrices.  Units whose token range holds no word < EXCEPTIONS cannot
   hold an exception marker: every position is a codeword start and the
   scan is skipped (the host planner buckets units into clean/dirty).

3. **Gather**: exclusive prefix sums of visited output lengths give each
   codeword's output offset; every output slot gathers its value from
   the dictionary table (or the inline exception words).  Run codewords
   (length > 16) read zeros beyond the 16-word zero region, matching the
   reference's pre-zeroed buffer + 16-word memcpy trick
   (dict_posting_list.hpp:296, single_dictionary.hpp:230-238).

``decode_units_plain`` is these phases as torch ops on one tile, X3's
plain version.  ``PassTable`` holds every tile of a pass on one device
(flat token, w_valid, n and ctx tensors, and on a card the row table of
``plan_rows``: a row a warp or a block, longest first), checked once;
``decode_pass`` decodes it: on a card ONE launch of X3 (each row's chain
cut by a team-wide scan of the boolean matrices, see the source's note)
into one fresh buffer whose views are the tiles' outputs, or the call
raises; on the CPU ``decode_pass_plain``, the plain version tile by tile.
``decode_units`` is the one-tile entry: on a card the same kernel over a
one-tile row table, on the CPU the plain version.

u32 data travels as int32 bit patterns: the table and the decoded
values are int32 tensors holding u32 bits, and the exception values are
assembled in int64 and wrapped back.  Index rules follow the
reference's gathers exactly: a negative ordinal wraps to the last one,
dictionary and table indices are clamped, and scatters that the
reference drops go to one padded column that is sliced off.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import EXCEPTIONS, MAX_ENTRY_SIZE
from .decode_local import _to_i32

_MASK = 0xFFFFFFFF


def _steps_for(b: int) -> Tuple[int, int, int]:
    """(dict, small_exc, large_exc) steps in token units."""
    tw = b // 8
    return 1, 1 + 2 // tw, 1 + 4 // tw


def _compose(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R = Y . X over the boolean semiring, elementwise over the trailing
    plane axes: R[i, j] = OR_k Y[i, k] & X[k, j].  x is the earlier
    prefix, y the later transform applied after it.  (D, D, ...) bool."""
    D = x.shape[0]
    r = y[:, 0, None] & x[None, 0]
    for k in range(1, D):
        r |= y[:, k, None] & x[None, k]
    return r


def _chain_visited(cw: torch.Tensor, b: int) -> torch.Tensor:
    """Visited mask over token positions via a log-step matrix scan.

    cw: (B, W) int32 token values.  Returns (B, W) bool.

    State s_q = (v_q, v_{q-1}, ..., v_{q-D+1}) with D the largest step;
    s_q = T_q s_{q-1}, where row 0 of T_q holds the recurrence taps
    v_q = v_{q-1} & dict_{q-1} | v_{q-s} & small_{q-s} | v_{q-l} &
    large_{q-l} and rows 1..D-1 shift the window.  The matrices are D*D
    (B, W-1) bool planes; the inclusive prefix P_q = T_q ... T_1 is
    built in ceil(log2(W-1)) doubling steps, and v_q = P_q[0, 0]
    (position 0 is always visited)."""
    B, W = cw.shape
    _, s_small, s_large = _steps_for(b)
    D = s_large  # max step == state depth
    if W == 1:
        return torch.ones((B, 1), dtype=torch.bool, device=cw.device)

    def shifted(x, k):
        # x_{q-k} aligned at q, False for q < k
        out = torch.zeros_like(x)
        if k < W:
            out[:, k:] = x[:, : W - k]
        return out

    a = shifted(cw >= EXCEPTIONS, 1)[:, 1:]
    bb = shifted(cw == 0, s_small)[:, 1:]
    cc = shifted(cw == 1, s_large)[:, 1:]
    L = W - 1
    T = torch.zeros((D, D, B, L), dtype=torch.bool, device=cw.device)
    T[0, 0] = a
    T[0, s_small - 1] |= bb
    T[0, s_large - 1] |= cc
    for i in range(1, D):
        T[i, i - 1] = True
    d = 1
    while d < L:
        later = T[..., d:]
        earlier = T[..., : L - d]
        T = torch.cat([T[..., :d], _compose(later, earlier)], dim=-1)
        d *= 2
    v0 = torch.ones((B, 1), dtype=torch.bool, device=cw.device)
    return torch.cat([v0, T[0, 0]], dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 with the reference's rule for the one
    out-of-range index it meets: a negative index wraps."""
    idx = torch.where(idx < 0, idx + x.shape[1], idx)
    return torch.gather(x, 1, idx.to(torch.int64))


def decode_units_plain(
    cw: torch.Tensor,  # (B, W) int32 token values
    w_valid: torch.Tensor,  # (B,) int32 valid token count per unit
    n: torch.Tensor,  # (B,) int32 ints to produce per unit
    ctx: torch.Tensor,  # (B,) int32 dictionary context per unit
    lengths: torch.Tensor,  # (C, E) int32 entry lengths
    offsets: torch.Tensor,  # (C, E) int32 entry table offsets
    table: torch.Tensor,  # (T,) int32 flat table, u32 bits, zero padded
    *,
    b: int = 16,
    n_out: int = 256,
    assume_clean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X3's plain version: decode a bucket of units in torch ops on the
    tensors' device; returns ((B, n_out) int32 holding the u32 values,
    (B,) int32 produced, (B,) int32 tokens consumed to produce exactly n
    ints)."""
    dev = cw.device
    B, W = cw.shape
    _, s_small, s_large = _steps_for(b)
    E = lengths.shape[1]
    Tn = table.shape[0]

    qpos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    in_range = qpos < w_valid[:, None]
    # out-of-range tokens look like dictionary codewords of length 0
    cw_safe = torch.where(in_range, cw, EXCEPTIONS)

    if assume_clean:
        visited = in_range
    else:
        visited = _chain_visited(cw_safe, b) & in_range

    ctx_l = ctx.to(torch.int64)[:, None]
    is_dict = cw_safe >= EXCEPTIONS
    ent_len = lengths[ctx_l, cw_safe.to(torch.int64).clamp(max=E - 1)]
    out_len = torch.where(is_dict, ent_len, 1)
    # unvisited and out-of-range positions produce nothing, so the ends
    # stay flat past the stream
    out_len = torch.where(visited, out_len, 0)

    ends = torch.cumsum(out_len, dim=1, dtype=torch.int32)  # inclusive
    produced = ends[:, -1]
    starts = ends - out_len

    # ordinal compaction of visited codewords; the reference's dropped
    # scatter slots land in column M, sliced off
    ordinal = torch.cumsum(visited, dim=1, dtype=torch.int32) - 1
    M = W  # max codewords
    scatter_idx = torch.where(visited, ordinal, M).to(torch.int64)
    pos_of_ord = torch.zeros((B, M + 1), dtype=torch.int32, device=dev)
    pos_of_ord.scatter_(1, scatter_idx, qpos.expand(B, W))
    pos_of_ord = pos_of_ord[:, :M]
    start_of_ord = torch.zeros((B, M + 1), dtype=torch.int32, device=dev)
    start_of_ord.scatter_(1, scatter_idx, starts)
    start_of_ord = start_of_ord[:, :M]

    # output slot -> ordinal: one mark at each codeword's start, cumsum.
    # Visited zero-length entries share a start, so the marks accumulate.
    num_ords = ordinal[:, -1] + 1
    ord_ids = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    ord_valid = ord_ids < num_ords[:, None]
    mark_idx = torch.where(ord_valid, start_of_ord, n_out)
    mark_idx = torch.where((mark_idx >= 0) & (mark_idx < n_out),
                           mark_idx, n_out).to(torch.int64)
    marks = torch.zeros((B, n_out + 1), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, mark_idx, torch.ones_like(mark_idx,
                                                    dtype=torch.int32))
    o_j = torch.cumsum(marks[:, :n_out], dim=1, dtype=torch.int32) - 1

    q_j = _take(pos_of_ord, o_j)
    st_j = _take(start_of_ord, o_j)
    jpos = torch.arange(n_out, dtype=torch.int32, device=dev)[None, :]
    k_j = jpos - st_j

    cw_j = _take(cw_safe, q_j)
    is_dict_j = cw_j >= EXCEPTIONS

    off_j = offsets[ctx_l, cw_j.to(torch.int64).clamp(max=E - 1)]
    k_clamped = torch.clamp(k_j, max=MAX_ENTRY_SIZE - 1)
    t_idx = (off_j + k_clamped).to(torch.int64)
    t_idx = torch.where(t_idx < 0, t_idx + Tn, t_idx).clamp(0, Tn - 1)
    tbl_val = table[t_idx].to(torch.int64) & _MASK
    dict_val = torch.where(k_j < MAX_ENTRY_SIZE, tbl_val, 0)

    # exception values from the following tokens (u32, built in int64)
    def tok(shift):
        idx = torch.clamp(q_j + shift, max=W - 1)
        return _take(cw_safe, idx).to(torch.int64) & _MASK

    if b == 16:
        small_val = tok(1)
        large_val = tok(1) | (tok(2) << 16)
    else:
        small_val = tok(1) | (tok(2) << 8)
        large_val = tok(1) | (tok(2) << 8) | (tok(3) << 16) | (tok(4) << 24)

    exc_val = torch.where(cw_j == 1, large_val, small_val) & _MASK
    val = torch.where(is_dict_j, dict_val, exc_val)
    val = torch.where(jpos < n[:, None], val, 0)

    # tokens consumed to produce exactly n ints: the codeword covering
    # output n-1, plus its payload — lets a second pass decode the data
    # that follows (e.g. the freqs half of an index block).
    last_j = torch.clamp(n - 1, 0, n_out - 1)[:, None]
    q_last = _take(q_j, last_j)[:, 0]
    cw_last = _take(cw_j, last_j)[:, 0]
    step_last = torch.where(
        cw_last >= EXCEPTIONS, 1,
        torch.where(cw_last == 1, s_large, s_small))
    consumed = (q_last + step_last).to(torch.int32)
    return _to_i32(val), produced, consumed


_X3_LIB = "libdintraw.so"
# X3's launch shape, as csrc/raw_decode.cu has it: a block of X3_THREADS
# threads; a row takes the block, each thread composing X3_RUN consecutive
# tokens, or a warp, each lane X3_WARP_RUN.
X3_THREADS = 256
X3_WARP = 32
X3_RUN = 4
X3_WARP_RUN = 2
X3_MAX_W = 1 << 29  # a row's positions stay below its codewords' kind bits
# Rows with at most this many tokens in range and slots take a warp each,
# X3_THREADS // X3_WARP rows of one group a block; longer rows a block.  A
# warp row walks 64 tokens a round, a block row 1,024: on the H100 rows of
# 257-1,024 tokens ran faster alone on a block, and both bench passes were
# no slower with 256 than with 512 or 1,024 (chip_smoke.py
# --x3-warp-tokens).
X3_WARP_ROW_TOKENS = 256
X3_WARP_ROW_SLOTS = 2048

# A row of X3's row table (``RowDesc`` in the source, 40 bytes): its first
# token in the pass's token buffer, its first slot in the value buffer,
# W, w_valid, n, ctx, n_out and the index of its produced and consumed.
ROW_DTYPE = np.dtype([("tok", "<i8"), ("out", "<i8"), ("W", "<i4"),
                      ("wv", "<i4"), ("n", "<i4"), ("ctx", "<i4"),
                      ("n_out", "<i4"), ("idx", "<i4")])


@dataclass(frozen=True)
class TileSpec:
    """A tile of a pass: ``rows`` rows of ``W`` tokens from token ``tok0``
    of the pass's token buffer, rows ``row0`` .. of its w_valid, n, ctx,
    produced and consumed, ``N`` slots a row from slot ``out0`` of its
    value buffer; width ``b``, ``clean`` (the chain scan skipped)."""

    b: int
    clean: bool
    W: int
    N: int
    rows: int
    row0: int
    tok0: int
    out0: int


def row_group(b: int, clean: bool) -> int:
    """A row's (b, clean) group as the kernel's switch reads it."""
    return int(b == 8) | int(clean) << 1


def row_cost(w_eff, n_out, clean, team):
    """A row's steps a thread on a team of ``team`` threads (X3_WARP or
    X3_THREADS): its chunks of team * run tokens, each run walked two or
    three times (a dirty chunk composes, walks and lists; a clean one
    walks and lists), and its slots, n_out / team a thread."""
    run = np.where(team == X3_WARP, X3_WARP_RUN, X3_RUN)
    chunks = -(-np.maximum(w_eff, 1) // (team * run))
    return (chunks * np.where(clean, 2, 3) * run
            + -(-np.asarray(n_out, np.int64) // team))


def plan_rows(specs, w_valid, n, ctx, warp_tokens=X3_WARP_ROW_TOKENS):
    """X3's row table for the tiles ``specs`` (w_valid, n, ctx: host arrays
    of every row in tile order): (rows, ROW_DTYPE, in launch order; items,
    (I, 4) int32 rows of (group, warp_rows, row0, rows), one a block).  A
    row with at most ``warp_tokens`` tokens in range and
    ``X3_WARP_ROW_SLOTS`` slots takes a warp, X3_THREADS // X3_WARP rows of one group a block; any other a
    block.  Items go by ``row_cost``, most first (the warp rows of a group
    sorted so before they are cut into blocks), so the longest rows start
    first and the short ones fill the tail."""
    R = sum(s.rows for s in specs)
    rows = np.zeros(R, ROW_DTYPE)
    group = np.zeros(R, np.int64)
    for s in specs:
        sl = slice(s.row0, s.row0 + s.rows)
        i = np.arange(s.rows, dtype=np.int64)
        rows["tok"][sl] = s.tok0 + i * s.W
        rows["out"][sl] = s.out0 + i * s.N
        rows["W"][sl] = s.W
        rows["n_out"][sl] = s.N
        group[sl] = row_group(s.b, s.clean)
    rows["wv"], rows["n"], rows["ctx"] = w_valid, n, ctx
    rows["idx"] = np.arange(R)
    w_eff = np.clip(rows["wv"], 0, rows["W"]).astype(np.int64)
    warp = (w_eff <= warp_tokens) & (rows["n_out"] <= X3_WARP_ROW_SLOTS)
    cost = row_cost(w_eff, rows["n_out"], (group & 2) != 0,
                    np.where(warp, X3_WARP, X3_THREADS))
    # (cost, group, warp_rows, members)
    work = [(int(cost[r]), int(group[r]), 0, np.asarray([r]))
            for r in np.flatnonzero(~warp)]
    per = X3_THREADS // X3_WARP
    for g in range(4):
        ids = np.flatnonzero(warp & (group == g))
        ids = ids[np.argsort(-cost[ids], kind="stable")]
        work += [(int(cost[ids[k]]), g, 1, ids[k : k + per])
                 for k in range(0, ids.shape[0], per)]
    work.sort(key=lambda w: (-w[0], w[1], w[2], int(w[3][0])))
    items = np.zeros((len(work), 4), np.int32)
    pos = 0
    for i, (_, g, wr, members) in enumerate(work):
        items[i] = (g, wr, pos, members.shape[0])
        pos += members.shape[0]
    order = (np.concatenate([w[3] for w in work]) if work
             else np.zeros(0, np.int64))
    return rows[order], items


def _check_ctx(ctx: np.ndarray, C: int) -> None:
    if ctx.size and (int(ctx.min()) < 0 or int(ctx.max()) >= C):
        raise ValueError(f"X3: every ctx must lie in [0, {C}), got "
                         f"[{int(ctx.min())}, {int(ctx.max())}]")


class PassTable:
    """What X3 decodes in one launch: the tiles ``specs`` (TileSpec) of a
    pass on one device, their rows' tokens, w_valid, n and ctx in flat
    int32 tensors (the tiles' rows in turn), and the dictionary
    (``lengths`` (C, E), ``offsets`` (C, E), ``table`` (T,)).  Every check
    runs here, once; on a card the row table and items of ``plan_rows``
    are uploaded here too, so that ``decode_pass`` is one allocation and
    one launch.  ``host``: (w_valid, n, ctx) as numpy arrays, where the
    caller has them (else they are read back); ``warp_tokens``: as
    ``plan_rows`` takes it."""

    def __init__(self, tokens, w_valid, n, ctx, specs, lengths, offsets,
                 table, host=None, warp_tokens=X3_WARP_ROW_TOKENS):
        name = "X3"
        self.device = tokens.device
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {self.device}")
        self.specs = list(specs)
        self.R = sum(s.rows for s in self.specs)
        self.slots = sum(s.rows * s.N for s in self.specs)
        for s in self.specs:
            if s.b not in (8, 16):
                raise ValueError(f"{name}: b must be 8 or 16, got {s.b}")
            if s.N < 1:
                raise ValueError(f"{name}: n_out must be at least 1, got "
                                 f"{s.N}")
            if not 1 <= s.W < X3_MAX_W or s.rows < 0:
                raise ValueError(f"{name}: a tile must be (B, W) with 1 <= "
                                 f"W < {X3_MAX_W}, got ({s.rows}, {s.W})")
            if s.tok0 + s.rows * s.W > tokens.numel():
                raise ValueError(f"{name}: a tile's tokens run past the "
                                 f"token buffer")
        for what, x in (("w_valid", w_valid), ("n", n), ("ctx", ctx)):
            if tuple(x.shape) != (self.R,):
                raise ValueError(f"{name}: {what} must be ({self.R},), got "
                                 f"{tuple(x.shape)}")
        if (lengths.dim() != 2 or tuple(offsets.shape) != tuple(lengths.shape)
                or lengths.shape[1] <= EXCEPTIONS or lengths.shape[0] < 1):
            raise ValueError(f"{name}: lengths and offsets must both be "
                             f"(C, E) with E > {EXCEPTIONS}, got "
                             f"{tuple(lengths.shape)} and "
                             f"{tuple(offsets.shape)}")
        if table.dim() != 1 or not 1 <= table.shape[0] < 1 << 31:
            raise ValueError(f"{name}: table must be (T,) with 1 <= T < "
                             f"2^31, got {tuple(table.shape)}")
        for x in (tokens, w_valid, n, ctx, lengths, offsets, table):
            if x.dtype != torch.int32 or x.device != self.device:
                raise ValueError(f"{name}: every tensor must be int32 on "
                                 f"{self.device}, got {x.dtype} on "
                                 f"{x.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}: every tensor must be contiguous")
        if host is None:
            host = torch.stack([w_valid, n, ctx]).cpu().numpy()
        _check_ctx(np.asarray(host[2]), lengths.shape[0])
        self.tokens, self.w_valid, self.n, self.ctx = tokens, w_valid, n, ctx
        self.lengths, self.offsets, self.table = lengths, offsets, table
        self.rows, self.items = plan_rows(self.specs, *host,
                                          warp_tokens=warp_tokens)
        if self.device.type == "cuda":
            up = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a).view(np.int32)).to(self.device)
            self._rows_t, self._items_t = up(self.rows), up(self.items)
            self._args = (tokens.data_ptr(), self._rows_t.data_ptr(),
                          self._items_t.data_ptr(), self.items.shape[0],
                          lengths.data_ptr(), offsets.data_ptr(),
                          table.data_ptr(), lengths.shape[1], table.shape[0])

    def tile(self, i: int):
        """Tile i's inputs: (cw (rows, W), w_valid, n, ctx), views."""
        s = self.specs[i]
        rs = slice(s.row0, s.row0 + s.rows)
        cw = self.tokens[s.tok0 : s.tok0 + s.rows * s.W].view(s.rows, s.W)
        return cw, self.w_valid[rs], self.n[rs], self.ctx[rs]


def pass_table(tiles, lengths, offsets, table,
               warp_tokens=X3_WARP_ROW_TOKENS) -> PassTable:
    """A PassTable on the dictionary's device from host tiles [(cw (rows,
    W), w_valid, n, ctx, b, n_out, clean)] (arrays of int32 values):
    their tokens, w_valid, n and ctx uploaded once, one tensor each;
    ``warp_tokens`` as ``plan_rows`` takes it."""
    specs, row0, tok0, out0 = [], 0, 0, 0
    for cw, _, _, _, b, N, clean in tiles:
        rows, W = cw.shape
        specs.append(TileSpec(int(b), bool(clean), int(W), int(N), rows,
                              row0, tok0, out0))
        row0, tok0, out0 = row0 + rows, tok0 + rows * W, out0 + rows * N

    def flat(k):
        parts = [np.asarray(t[k]).reshape(-1) for t in tiles]
        return np.concatenate(parts or [np.zeros(0)]).astype(np.int32)

    host = [flat(k) for k in (1, 2, 3)]
    dev = lengths.device
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return PassTable(up(flat(0)), *(up(a) for a in host), specs, lengths,
                     offsets, table, host=host, warp_tokens=warp_tokens)


class PassOutputs(Sequence):
    """A pass's outputs tile by tile, (out (rows, N) int32 u32 bits,
    produced (rows,), consumed (rows,)), views of the pass's one buffer
    (every value, then every produced, then every consumed) made when a
    tile is asked for."""

    def __init__(self, pt: PassTable, buf: torch.Tensor):
        self.pt, self.buf = pt, buf

    def __len__(self) -> int:
        return len(self.pt.specs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self)))]
        s = self.pt.specs[i]
        p0 = self.pt.slots + s.row0
        c0 = p0 + self.pt.R
        return (self.buf[s.out0 : s.out0 + s.rows * s.N].view(s.rows, s.N),
                self.buf[p0 : p0 + s.rows], self.buf[c0 : c0 + s.rows])


def decode_pass_plain(pt: PassTable):
    """X3's plain version over a pass: ``decode_units_plain`` tile by
    tile, [(out, produced, consumed)]."""
    return [decode_units_plain(*pt.tile(i), pt.lengths, pt.offsets,
                               pt.table, b=s.b, n_out=s.N,
                               assume_clean=s.clean)
            for i, s in enumerate(pt.specs)]


def decode_pass(pt: PassTable):
    """X3: every tile of ``pt`` decoded, [(out (rows, N) int32 u32 values,
    (rows,) produced, (rows,) consumed)] tile by tile, what
    ``decode_pass_plain`` returns.  On a card ONE launch of
    ``dint_raw_pass`` into one fresh buffer (or the call raises), the
    tiles' outputs views of it; on the CPU the plain version."""
    if pt.device.type == "cpu":
        return decode_pass_plain(pt)
    buf = torch.empty(pt.slots + 2 * pt.R, dtype=torch.int32,
                      device=pt.device)
    if pt.items.shape[0]:
        from . import cuda_ext

        p = buf.data_ptr()
        rc = cuda_ext.lib(_X3_LIB).dint_raw_pass(
            *pt._args, p, p + 4 * pt.slots, p + 4 * (pt.slots + pt.R),
            torch.cuda.current_stream(pt.device).cuda_stream)
        cuda_ext.check(_X3_LIB, "dint_raw_pass", rc)
        decode_pass.launches += 1
    return PassOutputs(pt, buf)


decode_pass.launches = 0


def decode_units(
    cw: torch.Tensor,  # (B, W) int32 token values
    w_valid: torch.Tensor,  # (B,) int32 valid token count per unit
    n: torch.Tensor,  # (B,) int32 ints to produce per unit
    ctx: torch.Tensor,  # (B,) int32 dictionary context per unit, in [0, C)
    lengths: torch.Tensor,  # (C, E) int32 entry lengths
    offsets: torch.Tensor,  # (C, E) int32 entry table offsets
    table: torch.Tensor,  # (T,) int32 flat table, u32 bits, zero padded
    *,
    b: int = 16,
    n_out: int = 256,
    assume_clean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X3 on one tile, returning what ``decode_units_plain`` returns
    ((B, n_out) int32 u32 values, (B,) produced, (B,) consumed): a
    one-tile pass table (w_valid, n and ctx read back to plan it, every
    check of ``PassTable``, a ctx outside [0, C) refused) through
    ``decode_pass``: on a CUDA device ONE launch of the pass's kernel, or
    the call raises; on the CPU the plain version."""
    if cw.dim() != 2 or cw.shape[1] < 1:
        raise ValueError(f"decode_units: cw must be (B, W) with W >= 1, got "
                         f"{tuple(cw.shape)}")
    if not cw.is_contiguous():
        raise ValueError("decode_units: every tensor must be contiguous")
    B, W = cw.shape
    spec = TileSpec(b, bool(assume_clean), W, n_out, B, 0, 0, 0)
    pt = PassTable(cw.reshape(-1), w_valid, n, ctx, [spec], lengths,
                   offsets, table)
    return decode_pass(pt)[0]


KERNELS = {"X3_raw_decode": decode_pass}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


def tokens_from_arena(
    arena_u8: np.ndarray, starts: np.ndarray, W: int, b: int
) -> np.ndarray:
    """Host-side token view: (B, W) int32 tokens for units at byte starts.

    Tokens are little-endian u16 (b=16) or u8 (b=8) read at
    ``starts[i] + tw*q`` — list payloads are NOT required to be aligned
    (the reference's streams aren't).
    """
    tw = b // 8
    starts = np.asarray(starts, dtype=np.int64)[:, None]
    q = np.arange(W, dtype=np.int64)[None, :]
    base = starts + tw * q
    base = np.minimum(base, arena_u8.shape[0] - tw)
    lo = arena_u8[base].astype(np.int32)
    if tw == 1:
        return lo
    hi = arena_u8[base + 1].astype(np.int32)
    return lo | (hi << 8)
