"""Cacheable block statistics with DSF filtering.

Reference: block_statistics.hpp.  Streams a collection, d-gaps docs
(freqs become freq-1), collects sub-block counts, filters blocks by the
DSF saving estimate (keeping singletons unconditionally), sorts by
(freq desc, length desc) and persists to disk with create-or-load
semantics (:26-43, :142-165).

On-disk format matches the reference byte-for-byte
(:111-140, :286-324): u64 total_integers, then per selector context a
u32 num_blocks followed by (u32 size, u32 freq, size × u32 data)
records.  The single variant has one context, the multi variant
NUM_SELECTORS contexts, and the cache filename patterns are
``<file>.block_statistics-16-adjusted`` and
``<file>.block_multi_statistics-16-adjusted.multi``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..config import (
    CODEWORD_BITS,
    DSF_FILTER_THRESHOLD,
    INITIAL_BPI,
    MAX_ENTRY_SIZE,
    NUM_ENTRIES,
    NUM_SELECTORS,
)
from ..io.collection import BinaryCollection
from ..utils import gaps as gap_mod
from ..utils import trace
from . import collectors


@dataclass
class SelectorStats:
    """Filtered, sorted block list for one selector context (SoA layout)."""

    lengths: np.ndarray  # (U,) int32
    freqs: np.ndarray  # (U,) int64
    data: np.ndarray  # (U, MAX_ENTRY_SIZE) u32, zero-padded beyond length
    # Optional uncapped columnar form (lens i32, freqs i64, vals u32
    # flat).  When the padded arrays above were capped to the
    # dictionary-target budget (create path), this carries the full
    # record set for store_stats without materializing U x 16 padding.
    full: tuple = None


@dataclass
class BlockStats:
    total_integers: int
    contexts: List[SelectorStats]

    @property
    def is_multi(self) -> bool:
        return len(self.contexts) > 1


def dsf_saving(lengths: np.ndarray, freqs: np.ndarray, total_integers: int) -> np.ndarray:
    """compute_saving (dictionary_builders.hpp:19-26)."""
    return (
        freqs.astype(np.float64)
        * (INITIAL_BPI * lengths.astype(np.float64) - CODEWORD_BITS)
        / float(total_integers)
    )


def _filter_sort(
    per_size: dict, total_integers: int, threshold: float = DSF_FILTER_THRESHOLD
) -> SelectorStats:
    """Apply the DSF cost filter + singleton keep, then (freq, length) sort."""
    lens_parts, freq_parts, data_parts = [], [], []
    for size, (windows, freqs) in per_size.items():
        if windows.shape[0] == 0:
            continue
        lengths = np.full(freqs.shape[0], size, dtype=np.int32)
        keep = (dsf_saving(lengths, freqs, total_integers) > threshold) | (
            lengths == 1
        )
        windows, freqs, lengths = windows[keep], freqs[keep], lengths[keep]
        padded = np.zeros((windows.shape[0], MAX_ENTRY_SIZE), dtype=np.uint32)
        padded[:, :size] = windows
        lens_parts.append(lengths)
        freq_parts.append(freqs)
        data_parts.append(padded)
    if not lens_parts:
        z = np.zeros(0, dtype=np.int64)
        return SelectorStats(
            z.astype(np.int32), z, np.zeros((0, MAX_ENTRY_SIZE), np.uint32)
        )
    lengths = np.concatenate(lens_parts)
    freqs = np.concatenate(freq_parts)
    data = np.concatenate(data_parts)
    # freq_length_sorter (statistics_collectors.hpp:57-64): freq desc,
    # tie-break length desc.  The reference's std::sort leaves further
    # ties unordered; we add a content tie-break for determinism.
    content_key = np.ascontiguousarray(data.byteswap()).view(
        np.dtype((np.void, MAX_ENTRY_SIZE * 4))
    ).ravel()
    order = np.lexsort((content_key, -lengths.astype(np.int64), -freqs))
    return SelectorStats(lengths[order], freqs[order], data[order])


def gap_stream(collection: BinaryCollection, compute_gaps: bool):
    """Yield the transformed (d-gap / freq-1) stream per list.

    Reference block_statistics.hpp:62-79: for docs, skip the leading
    num-docs singleton and d-gap each list; for freqs subtract 1.
    """
    from ..utils.progress import ProgressLogger

    it = iter(range(len(collection)))
    if compute_gaps:
        next(it)  # leading num-docs singleton
    prog = ProgressLogger(len(collection), "statistics: lists scanned")
    for i in it:
        prog.add()
        seq = collection.sequence(i)
        if seq.shape[0] == 0:
            continue
        if compute_gaps:
            yield gap_mod.docs_to_gaps(seq)
        else:
            yield gap_mod.freqs_to_gaps(seq)


def compute_stats(
    collection: BinaryCollection,
    compute_gaps: bool,
    multi: bool,
    padded_limit: int = None,
    device="cuda",
) -> BlockStats:
    """padded_limit: when set, each context's padded (U, 16) arrays are
    capped to the top padded_limit records (all the dictionary builder
    reads — targets_from_stats caps at num_entries), with the full
    record set carried in SelectorStats.full for store_stats.  The
    native collector runs first (native_stats.compute_stats_native);
    where it returns None the collectors of ``collectors.py`` count the
    windows, their large merges on ``device``, and ignore the limit
    (always full).  Timed as the span ``build.stats``."""
    from . import native_stats

    with trace.span("build.stats"):
        total = collection.num_postings() - (2 if compute_gaps else 0)
        contexts = native_stats.compute_stats_native(
            collection, compute_gaps, multi, total, padded_limit
        )
        if contexts is not None:
            return BlockStats(total, contexts)
        if multi:
            per_key = collectors.collect_multi(
                gap_stream(collection, compute_gaps), device=device)
            contexts = []
            for sel in range(NUM_SELECTORS):
                per_size = {s: per_key[(sel, s)]
                            for s in collectors.TARGET_SIZES}
                contexts.append(_filter_sort(per_size, total))
        else:
            per_size = collectors.collect_single(
                gap_stream(collection, compute_gaps), device=device)
            contexts = [_filter_sort(per_size, total)]
        return BlockStats(total, contexts)


def stats_cache_name(collection_path: str, multi: bool) -> str:
    base = os.path.basename(collection_path)
    if multi:
        return f"./{base}.block_multi_statistics-{MAX_ENTRY_SIZE}-adjusted.multi"
    return f"./{base}.block_statistics-{MAX_ENTRY_SIZE}-adjusted"


def _ragged_indices(lens: np.ndarray):
    """(rows, within) flat coordinates of every (i, j<lens[i]) pair.

    2D boolean masks (data[j < lens[:, None]]) go through numpy's
    nonzero machinery at ~8M elem/s; explicit repeat/arange index
    vectors with 1D flat gathers are ~50x faster at this scale."""
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    rows = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens[:-1])]), lens
    )
    return rows, within


def _ragged_gather(data: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate data[i, :lens[i]] over all rows."""
    from . import native_stats

    got = native_stats.ragged_flatten(lens, data)
    if got is not None:
        return got
    rows, within = _ragged_indices(lens)
    return data.ravel()[rows * data.shape[1] + within]


def _records_from_columnar(lens, freqs, vals) -> np.ndarray:
    """On-disk record stream from the columnar (lens, freqs, vals)."""
    from . import native_stats

    got = native_stats.records_from_flat(lens, freqs, vals)
    if got is not None:
        return got.view("<u4")
    return _ctx_records(SelectorStats(lens, freqs, _pad_ragged(lens, vals)))


def _ctx_records(ctx: SelectorStats) -> np.ndarray:
    """Flatten one context to the on-disk record stream:
    per record (u32 size, u32 freq, size x u32 data)."""
    from . import native_stats

    got = native_stats.records_build(ctx.lengths, ctx.freqs, ctx.data)
    if got is not None:
        return got.view("<u4")
    U = ctx.lengths.shape[0]
    lens = ctx.lengths.astype(np.int64)
    starts = np.zeros(U + 1, dtype=np.int64)
    np.cumsum(lens + 2, out=starts[1:])
    flat = np.zeros(int(starts[-1]), dtype="<u4")
    flat[starts[:-1]] = ctx.lengths.astype("<u4")
    flat[starts[:-1] + 1] = (
        ctx.freqs.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    ).astype("<u4")
    rows, within = _ragged_indices(lens)
    if rows.shape[0]:
        idx = np.repeat(starts[:-1] + 2, lens) + within
        flat[idx] = ctx.data.ravel()[rows * MAX_ENTRY_SIZE + within].astype("<u4")
    return flat


def store_stats(stats: BlockStats, path: str) -> None:
    """Writes the reference-format stats file plus a .npz sidecar that
    load_stats prefers (the record stream is sequentially delimited, so
    a faithful parse is a per-record walk; the sidecar keeps reloads
    vectorized).  Timed as the span ``build.cache``."""
    def columnar(ctx):
        if ctx.full is not None:
            return ctx.full
        return (
            ctx.lengths.astype(np.int32),
            ctx.freqs.astype(np.int64),
            _ragged_gather(ctx.data, ctx.lengths).astype(np.uint32),
        )

    with trace.span("build.cache"):
        cols = [columnar(ctx) for ctx in stats.contexts]
        with open(path, "wb") as f:
            np.asarray([stats.total_integers], dtype="<u8").tofile(f)
            for lens, freqs, vals in cols:
                np.asarray([lens.shape[0]], dtype="<u4").tofile(f)
                _records_from_columnar(lens, freqs, vals).tofile(f)
        try:
            with open(path + ".side", "wb") as f:
                np.asarray(
                    [_SIDE_MAGIC, stats.total_integers, len(stats.contexts)],
                    dtype="<i8",
                ).tofile(f)
                for lens, freqs, vals in cols:
                    np.asarray([lens.shape[0]], dtype="<i8").tofile(f)
                    lens.astype("<i4").tofile(f)
                    freqs.astype("<i8").tofile(f)
                    vals.astype("<u4").tofile(f)
        except OSError:
            pass


def _pad_ragged(lens: np.ndarray, flat_vals: np.ndarray) -> np.ndarray:
    from . import native_stats

    got = native_stats.ragged_pad(lens, flat_vals)
    if got is not None:
        return got
    data = np.zeros((lens.shape[0], MAX_ENTRY_SIZE), dtype=np.uint32)
    rows, within = _ragged_indices(lens)
    data.ravel()[rows * MAX_ENTRY_SIZE + within] = flat_vals
    return data


_SIDE_MAGIC = 0x53544154_00000001  # "STAT" + version


def _load_side(path: str, multi: bool, cap_single: bool):
    n_ctx = NUM_SELECTORS if multi else 1
    with open(path, "rb") as f:
        hdr = np.fromfile(f, dtype="<i8", count=3)
        if hdr.shape[0] != 3 or int(hdr[0]) != _SIDE_MAGIC or int(hdr[2]) != n_ctx:
            return None
        total = int(hdr[1])
        contexts = []
        for _ in range(n_ctx):
            num_blocks = int(np.fromfile(f, dtype="<i8", count=1)[0])
            lens = np.fromfile(f, dtype="<i4", count=num_blocks)
            freqs = np.fromfile(f, dtype="<i8", count=num_blocks)
            nv = int(lens.astype(np.int64).sum())
            flat = np.fromfile(f, dtype="<u4", count=nv)
            limit = (
                min(num_blocks, NUM_ENTRIES)
                if (cap_single and not multi)
                else num_blocks
            )
            if limit < num_blocks:
                flat = flat[: int(lens[:limit].astype(np.int64).sum())]
                lens, freqs = lens[:limit], freqs[:limit]
            contexts.append(
                SelectorStats(
                    lens.astype(np.int32),
                    freqs.astype(np.int64),
                    _pad_ragged(lens, flat),
                )
            )
    return BlockStats(total, contexts)


def load_stats(path: str, multi: bool, cap_single: bool = True) -> BlockStats:
    n_ctx = NUM_SELECTORS if multi else 1
    if os.path.exists(path + ".side"):
        got = _load_side(path + ".side", multi, cap_single)
        if got is not None:
            return got
    raw = np.fromfile(path, dtype=np.uint8)
    total = int(raw[:8].view("<u8")[0])
    words = raw[8:].view("<u4")
    pos = 0
    contexts = []
    for _ in range(n_ctx):
        num_blocks = int(words[pos])
        pos += 1
        # The single-variant loader caps at num_entries
        # (block_statistics.hpp:121-122); multi loads everything.
        limit = min(num_blocks, NUM_ENTRIES) if (cap_single and not multi) else num_blocks
        lengths = np.zeros(limit, dtype=np.int32)
        freqs = np.zeros(limit, dtype=np.int64)
        data = np.zeros((limit, MAX_ENTRY_SIZE), dtype=np.uint32)
        stop = limit if n_ctx == 1 else num_blocks
        for i in range(stop):
            size = int(words[pos])
            freq = int(words[pos + 1])
            if i < limit:
                lengths[i] = size
                freqs[i] = freq
                data[i, :size] = words[pos + 2 : pos + 2 + size]
            pos += 2 + size
        contexts.append(SelectorStats(lengths, freqs, data))
    return BlockStats(total, contexts)


def create_or_load(
    collection_path: str, compute_gaps: bool, multi: bool, cache_dir: str = ".",
    device="cuda",
) -> BlockStats:
    """create-or-load discipline (block_statistics.hpp:26-43); the
    collectors' merges, where they run, on ``device``."""
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, os.path.basename(stats_cache_name(collection_path, multi)))
    if os.path.exists(cache):
        return load_stats(cache, multi)
    coll = BinaryCollection(collection_path)
    stats = compute_stats(coll, compute_gaps, multi, padded_limit=NUM_ENTRIES,
                          device=device)
    try:
        store_stats(stats, cache)
    except OSError:
        pass
    return stats
