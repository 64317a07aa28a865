"""Skip-aware lazy block decode for the query path (host copy).

The port's copy of ``dint_tpu/query/lazy_decode.py``.  Numpy only, no
device step.

* The batch parser (``_tokens``, ``decode_unit_fast``,
  ``decode_units_fast_batch``, ``_decode_group``).
  ``DintIndex.ensure_docs_end`` uses it to recover where each block's
  docs half ends after a load.  Clean units (no exception codeword in
  the parsed prefix) decode as a few numpy ops over all units at once;
  dirty units take the scalar oracle (``codecs/dint.py``).  Byte
  consumption falls out of the parse.
* ``BlockCache``: per-(term, block) memo of decoded docids / freqs with
  decode counters (``docs_blocks_decoded``, ``freqs_blocks_decoded``,
  ``postings_scored``), which make pruning measurable.
* ``ZooBlockCache``: the same protocol over the block-codec indexes
  (``index/block_index.py``), so the cursors, WAND and maxscore run
  unchanged over every ``block_<codec>`` kind.
* ``Cursor``: the reference's document_enumerator: docid()/freq()/
  next()/next_geq() with block-max skipping (``next_geq`` binary-
  searches the list's block_max range, then the decoded block).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..codecs import dint, interpolative
from ..config import BLOCK_SIZE, EXCEPTIONS, MAX_ENTRY_SIZE, NUM_SELECTORS
from ..index.dint_index import DintIndex


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


class BlockCache:
    """Lazy per-block decode with memoization and counters."""

    def __init__(self, index: DintIndex):
        self.index = index
        self.docs_view = index.docs_dict.decode_view()
        self.freqs_view = index.freqs_dict.decode_view()
        self._docs: Dict[int, np.ndarray] = {}
        self._freqs: Dict[int, np.ndarray] = {}
        self._docs_end: Dict[int, int] = {}
        self.docs_blocks_decoded = 0
        self.freqs_blocks_decoded = 0
        self.postings_scored = 0

    def reset_counters(self) -> None:
        self.docs_blocks_decoded = 0
        self.freqs_blocks_decoded = 0
        self.postings_scored = 0

    def make_cursor(self, term: int) -> "Cursor":
        return Cursor(self, int(term))

    # ---- geometry helpers ----
    def _block_geom(self, term: int, b: int) -> Tuple[int, int, int]:
        """(size, base, pos_in_list) of global block b of `term`."""
        idx = self.index
        p0, p1 = idx.list_blocks(term)
        pos = (b - p0) * BLOCK_SIZE
        size = min(BLOCK_SIZE, int(idx.list_n[term]) - pos)
        base = int(idx.block_max[b - 1]) + 1 if b > p0 else 0
        return size, base, pos

    def _selector(self, start: int) -> Tuple[int, int, int]:
        """(ctx, b_bits, payload_start) for a full DINT block."""
        if self.index.kind == "multi":
            sc = int(self.index.arena[start])
            return sc % NUM_SELECTORS, (16 if sc < NUM_SELECTORS else 8), start + 1
        return 0, 16, start

    def docs_end_of(self, term: int, b: int) -> int:
        """Arena offset past block b's docs part (lazy per block)."""
        idx = self.index
        if idx.docs_end is not None:
            return int(idx.docs_end[b])
        if b in self._docs_end:
            return self._docs_end[b]
        self.docs_block(term, b)  # decoding discovers the offset
        return self._docs_end[b]

    # ---- block decodes ----
    def docs_block(self, term: int, b: int) -> np.ndarray:
        """Docids of global block b (decoded + memoized)."""
        got = self._docs.get(b)
        if got is not None:
            return got
        idx = self.index
        size, base, _ = self._block_geom(term, b)
        start = idx.block_start(b)
        self.docs_blocks_decoded += 1
        if size < BLOCK_SIZE:
            sum_v = int(idx.block_max[b]) - base - (size - 1)
            gaps, end = interpolative.decode_block(idx.arena, start, size, sum_v)
        else:
            ctx, bb, s = self._selector(start)
            gaps, consumed = decode_unit_fast(
                idx.arena, s, int(idx.block_end[b]), size,
                self.docs_view, ctx, bb,
            )
            end = s + consumed
        self._docs_end.setdefault(b, int(end))
        docs = (np.cumsum(gaps.astype(np.int64) + 1) - 1 + base).astype(
            np.uint32
        )
        self._docs[b] = docs
        return docs

    def docs_blocks_batch(self, pairs) -> None:
        """Warm the docids cache for many (term, block) pairs in one
        vectorized pass (decode_units_fast_batch); partial blocks go
        through the single-block path (they also discover docs_end)."""
        idx = self.index
        f_start, f_lim, f_sz, f_ctx, f_b, f_meta = [], [], [], [], [], []
        for t, b in pairs:
            if b in self._docs:
                continue
            size, base, _ = self._block_geom(t, b)
            start = idx.block_start(b)
            if size < BLOCK_SIZE:
                self.docs_block(t, b)
                continue
            ctx, bb, s = self._selector(start)
            f_start.append(s)
            f_lim.append(int(idx.block_end[b]))
            f_sz.append(size)
            f_ctx.append(ctx)
            f_b.append(bb)
            f_meta.append((b, base, s))
        if not f_start:
            return
        outs, consumed = decode_units_fast_batch(
            idx.arena, f_start, f_lim, f_sz, self.docs_view, f_ctx, f_b
        )
        self.docs_blocks_decoded += len(f_start)
        for (b, base, s), gaps, c in zip(f_meta, outs, consumed):
            self._docs_end.setdefault(b, s + int(c))
            self._docs[b] = (
                np.cumsum(gaps.astype(np.int64) + 1) - 1 + base
            ).astype(np.uint32)

    def freqs_blocks_batch(self, pairs) -> None:
        """Warm the freqs cache for many (term, block) pairs at once.
        Docs parts must locate the freq payload, so uncached docs
        blocks decode first (reference freq decode is likewise gated on
        the docs walk, dict_posting_list.hpp:311-318)."""
        idx = self.index
        todo = [(t, b) for t, b in pairs if b not in self._freqs]
        if not todo:
            return
        self.docs_blocks_batch(todo)
        f_start, f_lim, f_sz, f_ctx, f_b, f_ids = [], [], [], [], [], []
        part = []
        for t, b in todo:
            size, _, _ = self._block_geom(t, b)
            start = self.docs_end_of(t, b)
            if size < BLOCK_SIZE:
                part.append((b, start, size))
                continue
            ctx, bb, s = self._selector(start)
            f_start.append(s)
            f_lim.append(int(idx.block_end[b]))
            f_sz.append(size)
            f_ctx.append(ctx)
            f_b.append(bb)
            f_ids.append(b)
        if f_start:
            outs, _ = decode_units_fast_batch(
                idx.arena, f_start, f_lim, f_sz, self.freqs_view, f_ctx, f_b
            )
            self.freqs_blocks_decoded += len(f_start)
            for b, vals in zip(f_ids, outs):
                self._freqs[b] = (vals.astype(np.int64) + 1).astype(np.uint32)
        if part:
            specs = [
                (start, size, interpolative.UNKNOWN_SUM)
                for _, start, size in part
            ]
            decoded = interpolative.decode_blocks_batch(idx.arena, specs)
            self.freqs_blocks_decoded += len(part)
            for (b, _, _), vals in zip(part, decoded):
                self._freqs[b] = (vals.astype(np.int64) + 1).astype(np.uint32)

    def freqs_block(self, term: int, b: int) -> np.ndarray:
        """Freqs of global block b (lazy: dict_posting_list.hpp:164-169)."""
        got = self._freqs.get(b)
        if got is not None:
            return got
        idx = self.index
        size, _, _ = self._block_geom(term, b)
        start = self.docs_end_of(term, b)
        self.freqs_blocks_decoded += 1
        if size < BLOCK_SIZE:
            vals, _ = interpolative.decode_block(
                idx.arena, start, size, interpolative.UNKNOWN_SUM
            )
        else:
            ctx, bb, s = self._selector(start)
            vals, _ = decode_unit_fast(
                idx.arena, s, int(idx.block_end[b]), size,
                self.freqs_view, ctx, bb,
            )
        freqs = (vals.astype(np.int64) + 1).astype(np.uint32)
        self._freqs[b] = freqs
        return freqs


class ZooBlockCache:
    """BlockCache-compatible lazy decoder for the block-codec indexes
    (index/block_index.py — same SoA geometry, zoo codecs per block).
    Lets Cursor / WAND / maxscore / lazy AND run unchanged over all 11
    block index types."""

    def __init__(self, index):
        self.index = index
        index.ensure_docs_end()
        self._docs: Dict[int, np.ndarray] = {}
        self._freqs: Dict[int, np.ndarray] = {}
        self.docs_blocks_decoded = 0
        self.freqs_blocks_decoded = 0
        self.postings_scored = 0

    def reset_counters(self) -> None:
        self.docs_blocks_decoded = 0
        self.freqs_blocks_decoded = 0
        self.postings_scored = 0

    def docs_block(self, term: int, b: int) -> np.ndarray:
        got = self._docs.get(b)
        if got is None:
            self.docs_blocks_decoded += 1
            got = self.index.block_docs(b, term)
            self._docs[b] = got
        return got

    def freqs_block(self, term: int, b: int) -> np.ndarray:
        got = self._freqs.get(b)
        if got is None:
            self.freqs_blocks_decoded += 1
            got = self.index.block_freqs(b, term)
            self._freqs[b] = got
        return got

    def docs_blocks_batch(self, pairs) -> None:
        for t, b in pairs:
            self.docs_block(t, b)

    def freqs_blocks_batch(self, pairs) -> None:
        for t, b in pairs:
            self.freqs_block(t, b)

    def make_cursor(self, term: int) -> "Cursor":
        return Cursor(self, int(term))


class Cursor:
    """document_enumerator equivalent over the lazy block cache."""

    __slots__ = (
        "cache", "term", "p0", "p1", "n", "num_docs", "maxs",
        "_block", "_docs", "_pos", "_cur",
    )

    def __init__(self, cache: BlockCache, term: int):
        self.cache = cache
        self.term = term
        idx = cache.index
        self.p0, self.p1 = idx.list_blocks(term)
        self.n = int(idx.list_n[term])
        self.num_docs = int(idx.num_docs)
        self.maxs = idx.block_max[self.p0 : self.p1]
        self._block = -1
        self._docs = None
        self._pos = 0  # global position in list
        self._cur = self.num_docs
        if self.n:
            self._enter_block(0, 0)

    @property
    def size(self) -> int:
        return self.n

    def _enter_block(self, rel_b: int, pos_in_block: int) -> None:
        self._block = rel_b
        self._docs = self.cache.docs_block(self.term, self.p0 + rel_b)
        self._pos = rel_b * BLOCK_SIZE + pos_in_block
        self._cur = int(self._docs[pos_in_block])

    def docid(self) -> int:
        return self._cur

    def position(self) -> int:
        return self._pos

    def freq(self) -> int:
        f = self.cache.freqs_block(self.term, self.p0 + self._block)
        return int(f[self._pos - self._block * BLOCK_SIZE])

    def next(self) -> None:
        p = self._pos + 1
        if p >= self.n:
            self._cur = self.num_docs
            self._pos = self.n
            return
        rel_b, in_b = divmod(p, BLOCK_SIZE)
        if rel_b != self._block:
            self._enter_block(rel_b, in_b)
        else:
            self._pos = p
            self._cur = int(self._docs[in_b])

    def next_geq(self, target: int) -> None:
        """Advance to the first posting with docid >= target
        (dict_posting_list.hpp:126-147 semantics; block_max search
        instead of the reference's linear scan)."""
        if target <= self._cur:
            return
        rel_b = int(np.searchsorted(self.maxs, target, side="left"))
        if rel_b >= self.p1 - self.p0:
            self._cur = self.num_docs
            self._pos = self.n
            return
        if rel_b != self._block:
            self._enter_block(rel_b, 0)
        in_b = int(np.searchsorted(self._docs, target, side="left"))
        self._pos = self._block * BLOCK_SIZE + in_b
        self._cur = int(self._docs[in_b])


def make_cursors(cache: BlockCache, terms) -> list:
    return [Cursor(cache, int(t)) for t in terms]
