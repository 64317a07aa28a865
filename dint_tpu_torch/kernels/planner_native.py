"""ctypes binding for the native serving-image planner.

native/dint_planner.cpp builds the serving image (chop + FFD pack +
direct vidx + width-class split, its plan2 pass) and the per-unit
LocalPlan of the index query path (its first pass).  This module builds
it on first use into the port's build directory and exposes
plan_shard_image and plan_stream_native; both return None if the
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import nativebuild

_lib = None
_lib_failed = False


def get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = nativebuild.source_path("dint_planner.cpp")
    so = nativebuild.ensure_so(src, "libdintplan.so") if src else None
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    create_args = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.dint_planner_create.restype = ctypes.c_void_p
    lib.dint_planner_create.argtypes = create_args
    lib.dint_planner_destroy.argtypes = [ctypes.c_void_p]
    lib.dint_plan_units.restype = ctypes.c_int64
    lib.dint_plan_units.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int64
    ]
    lib.dint_plan_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.dint_planner2_create.restype = ctypes.c_void_p
    lib.dint_planner2_create.argtypes = create_args
    lib.dint_planner2_destroy.argtypes = [ctypes.c_void_p]
    lib.dint_plan2_units.restype = ctypes.c_int64
    lib.dint_plan2_units.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        + [ctypes.c_int64, ctypes.c_int64]
    )
    lib.dint_plan2_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.dint_plan2_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 13
    _lib = lib
    return _lib


def _view_arrays(view):
    table = np.ascontiguousarray(view.table, dtype=np.uint32)
    offsets = np.ascontiguousarray(view.offsets, dtype=np.uint32)
    lengths = np.ascontiguousarray(view.lengths, dtype=np.int32)
    return table, offsets, lengths


def plan_stream_native(
    arena: np.ndarray,
    starts,
    byte_lens,
    ns,
    ctxs,
    b_bits,
    view,
    w_tokens: int,
    n_out: int,
    table_cls: int,
):
    """The native per-unit plan (chop + local dictionaries, one or more
    rows per unit, no packing): the six LocalPlan arrays (tokens, meta,
    table, out_n, unit_id, out_pos), or None if the toolchain is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    table, offsets, lengths = _view_arrays(view)
    C, E = offsets.shape
    arena = np.ascontiguousarray(arena, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    byte_lens = np.ascontiguousarray(byte_lens, dtype=np.int64)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    ctxs = np.ascontiguousarray(ctxs, dtype=np.int32)
    b_bits = np.ascontiguousarray(b_bits, dtype=np.int32)
    U = starts.shape[0]
    h = lib.dint_planner_create(
        table.ctypes.data, table.shape[0], offsets.ctypes.data,
        lengths.ctypes.data, C, E, w_tokens, n_out, table_cls,
    )
    try:
        rows = lib.dint_plan_units(
            h, arena.ctypes.data, starts.ctypes.data, byte_lens.ctypes.data,
            ns.ctypes.data, ctxs.ctypes.data, b_bits.ctypes.data, U,
        )
        if rows < 0:
            raise ValueError(f"malformed unit {-1 - rows} in stream")
        tokens = np.empty((rows, w_tokens), np.int32)
        meta = np.empty((rows, w_tokens), np.int32)
        tab = np.empty((rows, table_cls), np.uint32)
        out_n = np.empty(rows, np.int32)
        unit_id = np.empty(rows, np.int64)
        out_pos = np.empty(rows, np.int64)
        lib.dint_plan_export(
            h, tokens.ctypes.data, meta.ctypes.data, tab.ctypes.data,
            out_n.ctypes.data, unit_id.ctypes.data, out_pos.ctypes.data,
        )
        return tokens, meta, tab, out_n, unit_id, out_pos
    finally:
        lib.dint_planner_destroy(h)


def plan_shard_image(
    arena: np.ndarray,
    starts: np.ndarray,
    byte_lens: np.ndarray,
    ns: np.ndarray,
    ctxs: np.ndarray,
    b_bits: np.ndarray,
    unit_base: int,
    view,
    w_tokens: int,
    n_out: int,
    table_cls: int,
):
    """Plan ONE shard of units straight to engine-ready class arrays
    (the native plan2 pass: chop + FFD pack + direct vidx + class
    split).  Returns a dict of numpy arrays or None if the native
    toolchain is unavailable.  Thread-safe across shards: each call
    owns a private handle and ctypes releases the GIL for the native
    work."""
    lib = get_lib()
    if lib is None:
        return None
    table, offsets, lengths = _view_arrays(view)
    C, E = offsets.shape
    arena = np.ascontiguousarray(arena, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    byte_lens = np.ascontiguousarray(byte_lens, dtype=np.int64)
    ns = np.ascontiguousarray(ns, dtype=np.int32)
    ctxs = np.ascontiguousarray(ctxs, dtype=np.int32)
    b_bits = np.ascontiguousarray(b_bits, dtype=np.int32)
    U = starts.shape[0]
    h = lib.dint_planner2_create(
        table.ctypes.data, table.shape[0], offsets.ctypes.data,
        lengths.ctypes.data, C, E, w_tokens, n_out, table_cls,
    )
    try:
        rc = lib.dint_plan2_units(
            h, arena.ctypes.data, starts.ctypes.data, byte_lens.ctypes.data,
            ns.ctypes.data, ctxs.ctypes.data, b_bits.ctypes.data, U,
            unit_base,
        )
        if rc < 0:
            raise ValueError(f"malformed unit {unit_base + (-1 - rc)}")
        sizes = np.zeros(4, np.int64)
        lib.dint_plan2_sizes(h, sizes.ctypes.data)
        r0, r16, r32, segs = (int(x) for x in sizes)
        out = dict(
            n0=np.empty(r0, np.int32),
            vidx16=np.empty((r16, n_out), np.uint8),
            tab16=np.empty((r16, table_cls // 2), np.uint32),
            n16=np.empty(r16, np.int32),
            vidx32=np.empty((r32, n_out), np.uint8),
            tab32=np.empty((r32, table_cls), np.uint32),
            n32=np.empty(r32, np.int32),
            seg_cls=np.empty(segs, np.uint8),
            seg_row=np.empty(segs, np.int64),
            seg_off=np.empty(segs, np.int32),
            seg_len=np.empty(segs, np.int32),
            seg_unit=np.empty(segs, np.int64),
            seg_pos=np.empty(segs, np.int64),
        )
        lib.dint_plan2_export(
            h, *(out[k].ctypes.data for k in (
                "n0", "vidx16", "tab16", "n16", "vidx32", "tab32", "n32",
                "seg_cls", "seg_row", "seg_off", "seg_len", "seg_unit",
                "seg_pos",
            ))
        )
        return out
    finally:
        lib.dint_planner2_destroy(h)
