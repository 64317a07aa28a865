"""Vectorized host parse of DINT codeword streams (host copy).

The port's copy of the batch parser of ``dint_tpu/query/lazy_decode.py``
(``_tokens``, ``decode_unit_fast``, ``decode_units_fast_batch``,
``_decode_group``).  ``DintIndex.ensure_docs_end`` uses it to recover
where each block's docs half ends after a load.  Clean units (no
exception codeword in the parsed prefix) decode as a few numpy ops over
all units at once; dirty units take the scalar oracle
(``codecs/dint.py``).  Byte consumption falls out of the parse.

``BlockCache``, ``ZooBlockCache`` and ``Cursor`` (the skip-aware lazy
decode of the host WAND/maxscore engines) are not ported yet: ROADMAP.md
'Modules still to port' item 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..codecs import dint
from ..config import EXCEPTIONS, MAX_ENTRY_SIZE


def _tokens(arena: np.ndarray, start: int, count: int, tw: int) -> np.ndarray:
    base = arena[start : start + count * tw]
    if tw == 2:
        return base[0::2].astype(np.int64) | (base[1::2].astype(np.int64) << 8)
    return base.astype(np.int64)


def decode_unit_fast(
    arena: np.ndarray,
    start: int,
    limit: int,
    size: int,
    view,
    ctx: int,
    b: int,
) -> Tuple[np.ndarray, int]:
    """Decode `size` gaps from a DINT codeword stream at `start`
    (stream bytes end somewhere at or before `limit`).

    Returns (values u32, consumed_bytes).  Vectorized when the parsed
    prefix contains no exception codewords; otherwise scalar oracle.
    """
    tw = b // 8
    avail = (limit - start) // tw
    toks = _tokens(arena, start, avail, tw)
    lengths = view.lengths[ctx]
    offsets = view.offsets[ctx]
    lns = lengths[toks]
    cs = np.cumsum(lns)
    k = int(np.searchsorted(cs, size, side="left"))
    if k < avail and int(cs[k]) == size and not (toks[: k + 1] < EXCEPTIONS).any():
        cw = toks[: k + 1]
        l = lns[: k + 1].astype(np.int64)
        ends = cs[: k + 1].astype(np.int64)
        starts_out = ends - l
        m = np.minimum(l, MAX_ENTRY_SIZE)
        offs = offsets[cw].astype(np.int64)
        out = np.zeros(size, dtype=np.uint32)
        cm = np.cumsum(m)
        total = int(cm[-1])
        rep = np.repeat(np.arange(k + 1), m)
        j = np.arange(total, dtype=np.int64) - np.repeat(cm - m, m)
        out[starts_out[rep] + j] = view.table[offs[rep] + j]
        return out, (k + 1) * tw
    # dirty (exception codewords) — scalar oracle
    out = np.zeros(size, dtype=np.uint32)
    end = dint.decode_single(view, arena, start, size, out, 0, b, ctx)
    return out, end - start


def decode_units_fast_batch(
    arena: np.ndarray,
    starts: np.ndarray,
    limits: np.ndarray,
    sizes: np.ndarray,
    view,
    ctxs: np.ndarray,
    b_bits: np.ndarray,
):
    """Vectorized decode of MANY DINT units in one numpy pass.

    Same clean-path trick as decode_unit_fast, batched: all units'
    tokens extract into one flat array, per-unit parses resolve with
    segmented cumsums, and one flat gather writes every output.  Units
    whose parsed prefix contains exception codewords (or whose parse
    does not land exactly on `size`) fall back to the scalar oracle
    individually.  Returns (values: list of u32 arrays,
    consumed: list of per-unit byte counts).
    """
    U = len(starts)
    starts = np.asarray(starts, np.int64)
    limits = np.asarray(limits, np.int64)
    sizes = np.asarray(sizes, np.int64)
    ctxs = np.asarray(ctxs, np.int64)
    b_bits = np.asarray(b_bits, np.int64)
    out: list = [None] * U
    consumed: list = [0] * U
    for ctx in np.unique(ctxs):
        for b in np.unique(b_bits):
            sel = np.flatnonzero((ctxs == ctx) & (b_bits == b))
            if sel.size == 0:
                continue
            _decode_group(
                arena, starts[sel], limits[sel], sizes[sel], view,
                int(ctx), int(b), sel, out, consumed,
            )
    return out, consumed


def _decode_group(arena, starts, limits, sizes, view, ctx, b, sel, out, consumed):
    tw = b // 8
    lengths = view.lengths[ctx]
    offsets = view.offsets[ctx]
    counts = (limits - starts) // tw
    total = int(counts.sum())
    U = len(starts)
    unit_of = np.repeat(np.arange(U, dtype=np.int64), counts)
    ccum = np.cumsum(counts) - counts
    pos_in = np.arange(total, dtype=np.int64) - np.repeat(ccum, counts)
    bpos = starts[unit_of] + pos_in * tw
    if tw == 2:
        toks = arena[bpos].astype(np.int64) | (
            arena[bpos + 1].astype(np.int64) << 8
        )
    else:
        toks = arena[bpos].astype(np.int64)
    lns = lengths[toks].astype(np.int64)
    gcs = np.cumsum(lns)
    base = np.repeat(gcs[ccum] - lns[ccum], counts)
    cs = gcs - base  # inclusive per-unit cumsum
    excl = cs - lns
    size_of = np.repeat(sizes, counts)
    used = excl < size_of
    # per-unit: parse is clean iff (a) total used length == size,
    # (b) no used token < EXCEPTIONS
    k_used = np.zeros(U, np.int64)
    np.add.at(k_used, unit_of[used], 1)
    ok_count = k_used > 0
    last_idx = np.minimum(ccum + k_used - 1, total - 1)
    exact = np.zeros(U, bool)
    exact[ok_count] = cs[last_idx[ok_count]] == sizes[ok_count]
    has_exc = np.zeros(U, bool)
    np.add.at(has_exc, unit_of[used & (toks < EXCEPTIONS)], True)
    clean = ok_count & exact & ~has_exc & (sizes > 0)
    clean_tok = used & clean[unit_of]

    # flat outputs for clean units
    ocum = np.cumsum(sizes) - sizes  # per-unit output base (flat layout)
    flat = np.zeros(int(sizes.sum()), np.uint32)
    ct_idx = np.flatnonzero(clean_tok)
    if ct_idx.size:
        l = lns[ct_idx]
        m = np.minimum(l, MAX_ENTRY_SIZE)
        offs = offsets[toks[ct_idx]].astype(np.int64)
        starts_out = ocum[unit_of[ct_idx]] + excl[ct_idx]
        cm = np.cumsum(m)
        tot = int(cm[-1])
        rep = np.repeat(np.arange(ct_idx.size, dtype=np.int64), m)
        j = np.arange(tot, dtype=np.int64) - np.repeat(cm - m, m)
        flat[starts_out[rep] + j] = view.table[offs[rep] + j]
    for u in range(U):
        if clean[u]:
            out[sel[u]] = flat[ocum[u] : ocum[u] + sizes[u]]
            consumed[sel[u]] = int(k_used[u]) * tw
        else:
            o = np.zeros(int(sizes[u]), dtype=np.uint32)
            end = dint.decode_single(
                view, arena, int(starts[u]), int(sizes[u]), o, 0, b, ctx
            )
            out[sel[u]] = o
            consumed[sel[u]] = end - int(starts[u])
