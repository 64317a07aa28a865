"""The ladder half of the native host library (ctypes over
native/query_host.cpp).

The ladder serving image (``kernels/unpack_device.py``) is built on the
host at load time: DINT units decode once, natively, and the value
stream re-packs into 256-value blocks at no-straddle ladder widths.
This module binds the three native entries that do it:

* ``decode_units_flat``: many DINT units into one flat u32 stream;
* ``decode_units_to_ladder``: decode -> classify -> bit-pack fused, straight
  to the per-width lane-major class arrays, never materializing the
  flat stream;
* ``ladder_from_values``: classify + pack + lane-transpose of an
  already-decoded value stream.

``native/query_host.cpp`` (with ``native/zoo_decode.cpp``) is compiled
read-only into the port's build directory at first use.  A failed build
raises with the compiler's message: the native route is the main path,
and the numpy route (``unpack_device.ladder_plan_from_values(...,
native=False)``) is only the oracle it is tested against.  The cursor
query engine of the same library is not bound here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import nativebuild

LADDER_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 10, 16, 32)

_SO = "libdintqh.so"
_lib = None


def get_lib():
    """The loaded library (built on first use); raises with the build
    error when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    src = nativebuild.source_path("query_host.cpp")
    zoo_src = nativebuild.source_path("zoo_decode.cpp")
    if src is None or zoo_src is None:
        raise RuntimeError("native/query_host.cpp and native/zoo_decode.cpp "
                           "are required for the ladder image build")
    # -ftls-model=initial-exec is the reference's build of this library;
    # where the loader is out of static TLS space the default model is
    # the fallback
    so = nativebuild.ensure_so(src, _SO, ["-ftls-model=initial-exec"],
                               extra_srcs=[zoo_src])
    lib = None
    if so is not None:
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            so = nativebuild.ensure_so(src, _SO, force=True,
                                       extra_srcs=[zoo_src])
            lib = ctypes.CDLL(so) if so is not None else None
    if lib is None:
        raise RuntimeError(
            f"native query host library unavailable "
            f"({nativebuild.errors.get(_SO, 'build failed').strip()})")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    units = [u32p, u32p, i32p, ctypes.c_int,
             u8p, i64p, i64p, i32p, i32p, i32p, ctypes.c_int64]
    lib.qh_decode_units_flat.restype = ctypes.c_int64
    lib.qh_decode_units_flat.argtypes = units + [i64p, u32p]
    lib.qh_ladder_build.restype = ctypes.c_int64
    lib.qh_ladder_build.argtypes = units + [ctypes.c_int32, handle_p]
    lib.qh_ladder_counts.restype = None
    lib.qh_ladder_counts.argtypes = [ctypes.c_void_p, i64p]
    lib.qh_ladder_tail_len.restype = ctypes.c_int64
    lib.qh_ladder_tail_len.argtypes = [ctypes.c_void_p]
    lib.qh_ladder_tail.restype = None
    lib.qh_ladder_tail.argtypes = [ctypes.c_void_p, u32p]
    lib.qh_ladder_fetch.restype = None
    lib.qh_ladder_fetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, u32p, ctypes.c_int64, i64p,
    ]
    lib.qh_ladder_from_values.restype = ctypes.c_int64
    lib.qh_ladder_from_values.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int, handle_p,
    ]
    lib.qh_ladder_vbase.restype = None
    lib.qh_ladder_vbase.argtypes = [ctypes.c_void_p, ctypes.c_int32, u32p]
    lib.qh_ladder_free.restype = None
    lib.qh_ladder_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _unit_args(view, arena, starts, byte_lens, ns, ctxs, b_bits):
    """The (kept-alive arrays, ctypes arguments) shared by the two unit
    decoders: the dictionary view, the arena and the unit geometry."""
    arrays = (
        np.ascontiguousarray(view.table, dtype=np.uint32),
        np.ascontiguousarray(view.offsets, dtype=np.uint32),
        np.ascontiguousarray(view.lengths, dtype=np.int32),
        np.ascontiguousarray(arena, dtype=np.uint8),
        np.ascontiguousarray(starts, dtype=np.int64),
        np.ascontiguousarray(byte_lens, dtype=np.int64),
        np.ascontiguousarray(ns, dtype=np.int32),
        np.ascontiguousarray(ctxs, dtype=np.int32),
        np.ascontiguousarray(b_bits, dtype=np.int32),
    )
    table, offs, lens, arena, starts, byte_lens, ns, ctxs, b_bits = arrays
    args = [
        _ptr(table, ctypes.c_uint32),
        _ptr(offs, ctypes.c_uint32),
        _ptr(lens, ctypes.c_int32),
        int(view.offsets.shape[0]) if view.offsets.ndim == 2 else 1,
        _ptr(arena, ctypes.c_uint8),
        _ptr(starts, ctypes.c_int64),
        _ptr(byte_lens, ctypes.c_int64),
        _ptr(ns, ctypes.c_int32),
        _ptr(ctxs, ctypes.c_int32),
        _ptr(b_bits, ctypes.c_int32),
        int(ns.shape[0]),
    ]
    return arrays, args


def decode_units_flat(view, arena, starts, byte_lens, ns, ctxs,
                      b_bits) -> np.ndarray:
    """Decode MANY DINT units into ONE flat u32 stream natively: the
    concatenated value stream in unit order."""
    lib = get_lib()
    arrays, args = _unit_args(view, arena, starts, byte_lens, ns, ctxs,
                              b_bits)
    ns = arrays[6]
    out_offs = np.zeros(ns.shape[0], dtype=np.int64)
    np.cumsum(ns[:-1], out=out_offs[1:])
    total = int(ns.astype(np.int64).sum())
    # +16 words of slack: each dictionary codeword memcpys 16 words
    out = np.zeros(total + 16, dtype=np.uint32)
    rc = lib.qh_decode_units_flat(
        *args, _ptr(out_offs, ctypes.c_int64), _ptr(out, ctypes.c_uint32))
    if rc != 0:
        raise ValueError(f"malformed unit {-(rc + 1)}")
    return out[:total]


def _fetch_classes(lib, handle, vpb: int, with_vbase: bool):
    """(classes, tail) of a finished native ladder builder: one (w,
    lane-major (W, M, 128) u32, out_base (N,) i64[, val_base (N,) u32])
    per non-empty ladder width, and the trailing partial block's
    values."""
    counts = np.zeros(len(LADDER_WIDTHS), dtype=np.int64)
    lib.qh_ladder_counts(handle, _ptr(counts, ctypes.c_int64))
    classes = []
    for slot, w in enumerate(LADDER_WIDTHS):
        n = int(counts[slot])
        if n == 0:
            continue
        vpw = 32 // w
        W = -(-vpb // vpw)
        m = max(1, -(-n // 128))
        lane = np.zeros((W, m, 128), dtype=np.uint32)
        out_base = np.zeros(n, dtype=np.int64)
        lib.qh_ladder_fetch(handle, slot, _ptr(lane, ctypes.c_uint32), m,
                            _ptr(out_base, ctypes.c_int64))
        if with_vbase:
            vbase = np.zeros(n, dtype=np.uint32)
            lib.qh_ladder_vbase(handle, slot, _ptr(vbase, ctypes.c_uint32))
            classes.append((w, lane, out_base, vbase))
        else:
            classes.append((w, lane, out_base))
    tl = int(lib.qh_ladder_tail_len(handle))
    tail = np.zeros(tl, dtype=np.uint32)
    if tl:
        lib.qh_ladder_tail(handle, _ptr(tail, ctypes.c_uint32))
    return classes, tail


def decode_units_to_ladder(view, arena, starts, byte_lens, ns, ctxs,
                           b_bits, vpb: int = 256):
    """Fused decode -> classify -> pack: DINT units straight to the
    ladder image's per-width lane-major class arrays.

    Returns (classes, tail) where classes is a list of
    (w, lane_major (W, M, 128) u32, out_base (N,) i64) for each
    non-empty ladder width and tail is the trailing partial block's
    values."""
    lib = get_lib()
    arrays, args = _unit_args(view, arena, starts, byte_lens, ns, ctxs,
                              b_bits)
    handle = ctypes.c_void_p()
    rc = lib.qh_ladder_build(*args, int(vpb), ctypes.byref(handle))
    if rc != 0:
        raise ValueError(f"malformed unit {-(rc + 1)}")
    try:
        return _fetch_classes(lib, handle, vpb, with_vbase=False)
    finally:
        lib.qh_ladder_free(handle)


def ladder_from_values(flat, vpb: int = 256, base_relative: bool = False):
    """Native classify + pack + lane-transpose of an already-decoded flat
    value stream into ladder classes.

    Returns (classes, tail) where classes is
    [(w, lane_major (W, M, 128) u32, out_base (N,) i64,
      val_base (N,) u32 | None)]."""
    lib = get_lib()
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    handle = ctypes.c_void_p()
    rc = lib.qh_ladder_from_values(
        _ptr(flat, ctypes.c_uint32), int(flat.shape[0]), int(vpb),
        1 if base_relative else 0, ctypes.byref(handle),
    )
    if rc != 0:
        raise RuntimeError(f"qh_ladder_from_values failed ({rc})")
    try:
        classes, tail = _fetch_classes(lib, handle, vpb, base_relative)
    finally:
        lib.qh_ladder_free(handle)
    if not base_relative:
        classes = [c + (None,) for c in classes]
    return classes, tail
