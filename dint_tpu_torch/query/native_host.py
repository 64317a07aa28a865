"""The native host library (ctypes over native/query_host.cpp): the
ladder image build and the cursor query engine.

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
native=False)``) is only the oracle it is tested against.

The same library holds the host serving path, ``NativeQueryEngine``:
the reference serves queries from C++ enumerators (queries.hpp:34-573);
this engine walks a DintIndex or BlockIndex structure-of-arrays
zero-copy (list_n / block_ptr / block_max / docs_end / block_end /
arena + the dictionary DecodeView tables) with native block decode and
the query algorithms of ``OPS``.  The Python engines (query/boolean.py,
query/ranked.py) remain the oracles it is tested against.  An EF-family
index serves through its u32 block view (``query/block_view.py``).

    eng = NativeQueryEngine(index, wdata)      # wdata optional for and/or
    times_us, counts, scores = eng.run("wand", queries, runs=10, k=10)
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from ..utils import nativebuild

LADDER_WIDTHS = (1, 2, 3, 4, 5, 6, 8, 10, 16, 32)

OPS = {
    "and": 0,
    "or": 1,
    "and_freq": 2,
    "or_freq": 3,
    "wand": 4,
    "maxscore": 5,
    "ranked_and": 6,
    "ranked_or": 7,
    # pair_wise_intersect semantics: AND with results materialized
    # into a num_docs buffer (src/pair_wise_intersect.cpp:28-59)
    "and_collect": 8,
}

# block-codec kind -> qh_create mode (16 + native codec id; ids 0-7 =
# zoo_many order in native/zoo_decode.cpp, 8 = qmx, 9 = u32)
BLOCK_CODEC_MODES = {
    "vbyte": 16, "maskedvbyte": 17, "streamvbyte": 18, "varintgb": 19,
    "varintg8iu": 20, "simple16": 21, "optpfor": 22,
    "interpolative": 23, "qmx": 24, "u32": 25,
}

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
                           "are required for the native host library")
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
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    lib.qh_create.restype = ctypes.c_void_p
    lib.qh_create.argtypes = [
        ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
        u32p, u64p, u32p, u64p, u64p, u8p,
        u32p, u32p, i32p, ctypes.c_int,
        u32p, u32p, i32p, ctypes.c_int,
        f32p, f32p,
    ]
    lib.qh_destroy.argtypes = [ctypes.c_void_p]
    lib.qh_run.restype = ctypes.c_int
    lib.qh_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u32p, u64p, ctypes.c_uint64, f64p, u64p, f32p,
    ]
    lib.qh_dict_copy.restype = ctypes.c_double
    lib.qh_dict_copy.argtypes = [
        u32p, u32p, i32p, ctypes.c_int, u32p, ctypes.c_uint64,
        ctypes.c_uint32,
    ]
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


def available() -> bool:
    """Whether the library builds and loads here (the build error of a
    False stays in ``nativebuild.errors``)."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


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


def dict_copy_ns(view, indexes: np.ndarray, runs: int = 10) -> float:
    """Native random-copy microbenchmark over a dictionary DecodeView
    (the src/dict_perf_test.cpp:43-63 loop: one 16-word memcpy + length
    read per index, `runs` passes).  Returns avg ns per copy."""
    lib = get_lib()
    table = np.ascontiguousarray(view.table, dtype=np.uint32)
    offs = np.ascontiguousarray(view.offsets, dtype=np.uint32)
    lens = np.ascontiguousarray(view.lengths, dtype=np.int32)
    idx = np.ascontiguousarray(indexes, dtype=np.uint32)
    contexts = int(view.offsets.shape[0]) if view.offsets.ndim == 2 else 1
    return float(lib.qh_dict_copy(
        _ptr(table, ctypes.c_uint32),
        _ptr(offs, ctypes.c_uint32),
        _ptr(lens, ctypes.c_int32),
        contexts,
        _ptr(idx, ctypes.c_uint32),
        idx.shape[0],
        runs,
    ))


class _NullView:
    """Stand-in dictionary view for dictionary-less (block-codec)
    indexes: 1-context zero tables the native side never reads."""

    def __init__(self):
        self.table = np.zeros(1, np.uint32)
        self.offsets = np.zeros((1, 1), np.uint32)
        self.lengths = np.zeros((1, 1), np.int32)


class NativeQueryEngine:
    """Holds a native context over a DintIndex or BlockIndex
    (+ optional WandData)."""

    def __init__(self, index, wdata=None):
        lib = get_lib()
        self._lib = lib
        self.index = index
        self.num_docs = int(index.num_docs)
        self.num_lists = int(index.num_lists)
        if hasattr(index, "docs_dict"):
            mode = 1 if index.kind == "multi" else 0
            dv = index.docs_dict.decode_view()
            fv = index.freqs_dict.decode_view()
        else:
            mode = BLOCK_CODEC_MODES[index.codec]
            dv = _NullView()
            fv = _NullView()
        # keep every array referenced: the context borrows them zero-copy
        self._keep = keep = []

        def prep(a, dtype):
            a = np.ascontiguousarray(a, dtype=dtype)
            keep.append(a)
            return a

        list_n = prep(index.list_n, np.uint32)
        block_ptr = prep(index.block_ptr, np.uint64)
        block_max = prep(index.block_max, np.uint32)
        index.ensure_docs_end()
        docs_end = prep(index.docs_end, np.uint64)
        block_end = prep(index.block_end, np.uint64)
        # +16 zero bytes of slack: the native interpolative BitReader
        # does unaligned 64-bit loads that may read past a block's last
        # payload byte (never past the pad)
        arena = np.concatenate(
            [np.ascontiguousarray(index.arena, dtype=np.uint8),
             np.zeros(16, np.uint8)]
        )
        keep.append(arena)
        d_table = prep(dv.table, np.uint32)
        d_off = prep(dv.offsets, np.uint32)
        d_len = prep(dv.lengths, np.int32)
        f_table = prep(fv.table, np.uint32)
        f_off = prep(fv.offsets, np.uint32)
        f_len = prep(fv.lengths, np.int32)
        if wdata is not None:
            norm = prep(wdata.norm_lens, np.float32)
            maxw = prep(wdata.max_term_weight, np.float32)
        else:
            norm = prep(np.zeros(self.num_docs, np.float32), np.float32)
            maxw = prep(np.zeros(self.num_lists, np.float32), np.float32)
        assert norm.shape[0] == self.num_docs
        assert maxw.shape[0] == self.num_lists

        self._ctx = lib.qh_create(
            mode,
            self.num_lists, self.num_docs,
            _ptr(list_n, ctypes.c_uint32),
            _ptr(block_ptr, ctypes.c_uint64),
            _ptr(block_max, ctypes.c_uint32),
            _ptr(docs_end, ctypes.c_uint64),
            _ptr(block_end, ctypes.c_uint64),
            _ptr(arena, ctypes.c_uint8),
            _ptr(d_table, ctypes.c_uint32),
            _ptr(d_off, ctypes.c_uint32),
            _ptr(d_len, ctypes.c_int32),
            int(dv.offsets.shape[0]),
            _ptr(f_table, ctypes.c_uint32),
            _ptr(f_off, ctypes.c_uint32),
            _ptr(f_len, ctypes.c_int32),
            int(fv.offsets.shape[0]),
            _ptr(norm, ctypes.c_float),
            _ptr(maxw, ctypes.c_float),
        )

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.qh_destroy(ctx)
            self._ctx = None

    def run(
        self,
        op: str,
        queries: Sequence[Sequence[int]],
        runs: int = 11,
        k: int = 10,
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Run the whole query batch ``runs`` times (first run untimed,
        src/queries.cpp:29-32).  Returns (times_us of shape
        (runs-1, Q), result counts (Q,), top-k scores (Q, k) descending
        padded with -1 for ranked ops else None)."""
        assert runs >= 2, "first run is untimed warmup"
        assert 0 < k <= 256
        opc = OPS[op]
        Q = len(queries)
        lens = np.fromiter((len(q) for q in queries), np.int64, Q)
        qoffs = np.zeros(Q + 1, dtype=np.uint64)
        np.cumsum(lens, out=qoffs[1:].view(np.int64))
        qterms = np.fromiter(
            (int(t) for q in queries for t in q), np.uint32, int(lens.sum())
        )
        if qterms.shape[0]:
            assert int(qterms.max()) < self.num_lists
        out_us = np.zeros((runs - 1) * Q, dtype=np.float64)
        out_cnt = np.zeros(Q, dtype=np.uint64)
        ranked = opc >= 4
        out_scores = (
            np.full(Q * k, -1.0, dtype=np.float32) if ranked else None
        )
        rc = self._lib.qh_run(
            self._ctx, opc, k, runs,
            _ptr(qterms, ctypes.c_uint32),
            _ptr(qoffs, ctypes.c_uint64),
            Q,
            _ptr(out_us, ctypes.c_double),
            _ptr(out_cnt, ctypes.c_uint64),
            _ptr(out_scores, ctypes.c_float) if ranked else None,
        )
        if rc != 0:
            raise RuntimeError(f"qh_run failed ({rc})")
        scores = out_scores.reshape(Q, k) if ranked else None
        return out_us.reshape(runs - 1, Q), out_cnt, scores
