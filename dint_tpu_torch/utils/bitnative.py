"""ctypes bindings for the native word-parallel EF decoder (host copy).

native/ef_decode.cpp vectorizes the reference's enumerator walk
(compact_elias_fano.hpp:263-388): ctz/popcount word select over the
high bits fused with sequential low-bit field extraction.  It is
compiled read-only into the port's build directory (``libefdec.so``)
at first use; a library that does not build raises with the
compiler's message.  The numpy paths in bitio.py / ef.py stay as the
cross-checked oracle, and still take over for words the native calls
refuse (not a contiguous u64 array): those calls then return None.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import nativebuild

_SO = "libefdec.so"
_lib = None


def get_lib():
    """The loaded library (built on first use); raises with the build
    error when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    src = nativebuild.source_path("ef_decode.cpp")
    if src is None:
        raise RuntimeError("native/ef_decode.cpp is required for the EF "
                           "decoders")
    so = nativebuild.ensure_so(src, _SO)
    if so is None:
        raise RuntimeError(
            f"native EF library unavailable "
            f"({nativebuild.errors.get(_SO, 'build failed').strip()})")
    lib = ctypes.CDLL(so)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ef_select_all.restype = ctypes.c_int64
    lib.ef_select_all.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int64, u64p,
    ]
    lib.ef_read_fields_seq.restype = None
    lib.ef_read_fields_seq.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_int64, u64p,
    ]
    lib.ef_decode_fused.restype = ctypes.c_int64
    lib.ef_decode_fused.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64, u64p,
    ]
    lib.pef_decode_all.restype = ctypes.c_int
    lib.pef_decode_all.argtypes = [
        u64p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, u64p,
    ]
    lib.opt_partition.restype = ctypes.c_int64
    lib.opt_partition.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def _wp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _words_ok(words: np.ndarray) -> bool:
    return (
        isinstance(words, np.ndarray)
        and words.dtype == np.uint64
        and words.flags.c_contiguous
    )


def select_all(words: np.ndarray, start: int, end: int,
               n: int) -> Optional[np.ndarray]:
    """First n one-positions in [start, end), relative to start.

    Returns None when the input isn't a contiguous u64 array (callers
    fall back to numpy)."""
    lib = get_lib()
    if not _words_ok(words):
        return None
    out = np.empty(n, dtype=np.uint64)
    k = lib.ef_select_all(
        _wp(words), words.shape[0], start, end, n, _wp(out))
    if k != n:
        raise ValueError(f"select_all: found {k} ones, wanted {n}")
    return out


def read_fields_seq(words: np.ndarray, start: int, width: int,
                    n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if not _words_ok(words):
        return None
    out = np.empty(n, dtype=np.uint64)
    lib.ef_read_fields_seq(_wp(words), words.shape[0], start, width, n,
                           _wp(out))
    return out


def ef_decode_fused(words: np.ndarray, high_off: int, high_len: int,
                    low_off: int, low_bits: int,
                    n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if not _words_ok(words):
        return None
    out = np.empty(n, dtype=np.uint64)
    k = lib.ef_decode_fused(
        _wp(words), words.shape[0], high_off, high_len, low_off,
        low_bits, n, _wp(out))
    if k != n:
        raise ValueError(f"ef_decode_fused: decoded {k} of {n}")
    return out


def pef_decode_all(words: np.ndarray, offset: int, universe: int, n: int,
                   p, uniform: bool, strict: bool) -> Optional[np.ndarray]:
    """Whole partitioned-sequence decode; None when the native walk
    refuses the input (the caller falls back to numpy)."""
    lib = get_lib()
    if not _words_ok(words):
        return None
    out = np.empty(n, dtype=np.uint64)
    rc = lib.pef_decode_all(
        _wp(words), words.shape[0], offset, universe, n,
        p.ef_log_sampling0, p.ef_log_sampling1,
        p.rb_log_rank1_sampling, p.rb_log_sampling1,
        1 if uniform else 0, p.log_partition_size, 1 if strict else 0,
        _wp(out))
    if rc != 0:
        return None
    return out


def opt_partition(values: np.ndarray, universe: int, p, eps1: float,
                  eps2: float, fix_cost: float,
                  strict: bool):
    """Native PEF partitioning DP (optimal_partition.hpp:69-121 over the
    indexed/strict sequence bitsize costs); None when the native DP
    refuses the input (the caller runs the python DP).  Returns the
    ascending partition endpoint list (last == n)."""
    lib = get_lib()
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = int(v.shape[0])
    out = np.empty(n + 1, dtype=np.int64)
    cnt = lib.opt_partition(
        _wp(v), n, universe, eps1, eps2, fix_cost, 1 if strict else 0,
        p.ef_log_sampling0, p.ef_log_sampling1,
        p.rb_log_rank1_sampling, p.rb_log_sampling1,
        n + 1, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if cnt < 0:
        return None
    return out[:cnt].tolist()
