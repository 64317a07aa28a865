"""ctypes bindings for the native C++ statistics collector.

Builds native/dint_stats.cpp on first use (g++ -O3 shared object, in
the port's build directory; see utils/nativebuild.py): exact content
counting (hash + arena verify, no collision conflation), the DSF
filter and the (freq desc, len desc, content asc) sort.  The port has
no numpy fallback for the collectors: without the native library the
statistics stage raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..config import (
    BLOCK_SIZE,
    CODEWORD_BITS,
    DSF_FILTER_THRESHOLD,
    INITIAL_BPI,
    MAX_ENTRY_SIZE,
    NUM_SELECTORS,
    TARGET_SIZES,
)
from ..utils import nativebuild

_lib = None
_lib_failed = False


def get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = nativebuild.source_path("dint_stats.cpp")
    so = nativebuild.ensure_so(src, "libdintstats.so") if src else None
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    lib.stats_create.restype = ctypes.c_void_p
    lib.stats_create.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.stats_destroy.argtypes = [ctypes.c_void_p]
    lib.stats_add.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.stats_finalize.restype = ctypes.c_int64
    lib.stats_finalize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.stats_export.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ragged_pad.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.ragged_flatten.argtypes = lib.ragged_pad.argtypes
    lib.records_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.collection_gaps.restype = ctypes.c_int64
    lib.collection_gaps.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.stats_vals_words.restype = ctypes.c_int64
    lib.stats_vals_words.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stats_export_flat.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.records_from_flat.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def records_from_flat(lens, freqs, vals) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    out = np.empty(vals.shape[0] + 2 * lens.shape[0], dtype=np.uint32)
    lib.records_from_flat(
        lens.ctypes.data, freqs.ctypes.data, vals.ctypes.data,
        lens.shape[0], out.ctypes.data,
    )
    return out


def collection_gap_arrays(collection, compute_gaps: bool):
    """(flat gaps, offsets) for a whole BinaryCollection in one native
    pass — replaces the per-list python gap_stream for large builds.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    offs = collection._offsets
    lens = collection._lengths
    if compute_gaps:  # leading num-docs singleton
        offs, lens = offs[1:], lens[1:]
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = offs.shape[0]
    total = int(lens.sum())
    out = np.empty(total, dtype=np.uint32)
    out_offs = np.empty(n + 1, dtype=np.int64)
    words = collection._data
    assert words.dtype == np.dtype("<u4")
    ptr = words.ctypes.data if hasattr(words, "ctypes") else None
    wrote = lib.collection_gaps(
        ptr, offs.ctypes.data, lens.ctypes.data, n,
        1 if compute_gaps else 0, out.ctypes.data, out_offs.ctypes.data,
    )
    assert wrote == total, (wrote, total)
    return out, out_offs


def compute_stats_native(collection, compute_gaps: bool, multi: bool,
                         total_integers: int, padded_limit: int = None):
    """Whole-pipeline native path: gap transform + collect + filter +
    sort, no per-list python.  Returns list of SelectorStats or None.

    With padded_limit, the padded (U, 16) arrays hold only the top
    padded_limit records and SelectorStats.full carries the complete
    columnar record set (for store_stats)."""
    lib = get_lib()
    if lib is None:
        return None
    got = collection_gap_arrays(collection, compute_gaps)
    if got is None:
        return None
    flat, out_offs = got
    from .block_stats import SelectorStats

    sizes = np.asarray(TARGET_SIZES, dtype=np.int32)
    h = lib.stats_create(
        1 if multi else 0, sizes.ctypes.data, len(TARGET_SIZES),
        BLOCK_SIZE, NUM_SELECTORS,
    )
    try:
        lib.stats_add(
            h, flat.ctypes.data, out_offs.ctypes.data, out_offs.shape[0] - 1
        )
        del flat, out_offs
        contexts = []
        for ctx in range(NUM_SELECTORS if multi else 1):
            u = lib.stats_finalize(
                h, ctx, float(total_integers), float(INITIAL_BPI),
                float(CODEWORD_BITS), float(DSF_FILTER_THRESHOLD),
            )
            if padded_limit is not None:
                full_lens = np.empty(u, dtype=np.int32)
                full_freqs = np.empty(u, dtype=np.int64)
                vals = np.empty(int(lib.stats_vals_words(h, ctx)), np.uint32)
                if u:
                    lib.stats_export_flat(
                        h, ctx, full_lens.ctypes.data,
                        full_freqs.ctypes.data, vals.ctypes.data,
                    )
                k = min(u, int(padded_limit))
                lens, freqs = full_lens[:k], full_freqs[:k]
                data = ragged_pad(
                    lens, vals[: int(lens.astype(np.int64).sum())]
                )
                contexts.append(
                    SelectorStats(
                        lens, freqs, data, full=(full_lens, full_freqs, vals)
                    )
                )
                continue
            lens = np.empty(u, dtype=np.int32)
            freqs = np.empty(u, dtype=np.int64)
            # stats_export fully writes every row (memset padding), so
            # empty alloc avoids zeroing 100s of MB twice
            data = np.empty((u, MAX_ENTRY_SIZE), dtype=np.uint32)
            if u:
                lib.stats_export(
                    h, ctx, MAX_ENTRY_SIZE, lens.ctypes.data,
                    freqs.ctypes.data, data.ctypes.data,
                )
            contexts.append(SelectorStats(lens, freqs, data))
        return contexts
    finally:
        lib.stats_destroy(h)


def ragged_pad(lens: np.ndarray, flat: np.ndarray) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    out = np.empty((lens.shape[0], MAX_ENTRY_SIZE), dtype=np.uint32)
    lib.ragged_pad(
        lens.ctypes.data, lens.shape[0], MAX_ENTRY_SIZE,
        flat.ctypes.data, out.ctypes.data,
    )
    return out


def ragged_flatten(lens: np.ndarray, data: np.ndarray) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint32)
    out = np.empty(int(lens.astype(np.int64).sum()), dtype=np.uint32)
    lib.ragged_flatten(
        lens.ctypes.data, lens.shape[0], MAX_ENTRY_SIZE,
        data.ctypes.data, out.ctypes.data,
    )
    return out


def records_build(lens, freqs, data) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint32)
    out = np.empty(
        int(lens.astype(np.int64).sum()) + 2 * lens.shape[0], dtype=np.uint32
    )
    lib.records_build(
        lens.ctypes.data, freqs.ctypes.data, data.ctypes.data,
        lens.shape[0], MAX_ENTRY_SIZE, out.ctypes.data,
    )
    return out
