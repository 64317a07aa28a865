"""ctypes bindings for the native C++ DINT encoder.

Builds native/dint_encoder.cpp on first use (g++ -O3 shared object, in
the port's build directory; see utils/nativebuild.py) and exposes the
unit-encoding API that encode_batch drives.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..config import NUM_ENTRIES
from ..dictionary.dictionary import DecodeView
from ..utils import nativebuild

_lib = None
_lib_failed = False


def get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = nativebuild.source_path("dint_encoder.cpp")
    if src is None:
        _lib_failed = True
        return None
    # -ftls-model=initial-exec: the encoder's thread_local scratch is on
    # every hot path, and the default global-dynamic model in a dlopen'd
    # shared object routes each access through __tls_get_addr — measured
    # 19 -> 29 M ints/s end-to-end from this one flag.  If the process
    # has exhausted its static TLS surplus the dlopen fails cleanly and
    # we rebuild with the default model.
    so = nativebuild.ensure_so(
        src, "libdintenc.so", ["-ftls-model=initial-exec"]
    )
    if so is None:
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        # out of static TLS space: rebuild with the default TLS model
        so = nativebuild.ensure_so(src, "libdintenc.so", force=True)
        if so is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(so)
    lib.dint_encoder_create.restype = ctypes.c_void_p
    lib.dint_encoder_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.dint_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.dint_encode_units.restype = ctypes.c_int64
    lib.dint_encode_units.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


class NativeEncoder:
    """Holds a native encoder handle for one dictionary."""

    def __init__(self, view: DecodeView, context_counts: Sequence[int]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native encoder unavailable")
        self._lib = lib
        C = view.offsets.shape[0]
        table = np.ascontiguousarray(view.table, dtype=np.uint32)
        offsets = np.ascontiguousarray(view.offsets, dtype=np.uint32)
        lengths = np.ascontiguousarray(view.lengths, dtype=np.int32)
        counts = np.ascontiguousarray(
            np.minimum(np.asarray(context_counts, dtype=np.int32), NUM_ENTRIES)
        )
        self._keep = (table, offsets, lengths, counts)
        self._h = lib.dint_encoder_create(
            table.ctypes.data, table.shape[0], offsets.ctypes.data,
            lengths.ctypes.data, counts.ctypes.data, C, NUM_ENTRIES,
        )

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.dint_encoder_destroy(self._h)
        except Exception:
            pass

    def encode_units(self, units: Sequence[np.ndarray], mode: int) -> List[bytes]:
        """mode 0 = single opt b16; 1 = multi exhaustive with selector byte."""
        if not units:
            return []
        offs = np.zeros(len(units) + 1, dtype=np.int64)
        np.cumsum([len(u) for u in units], out=offs[1:])
        # Builders pass consecutive views of ONE contiguous gap array
        # (index/dint_index.py chops dgap/fgap in order): detect that
        # and skip the concatenate — re-copying the whole stream costs
        # more than small-unit bookkeeping on this host.
        flat = None
        first = np.asarray(units[0])
        if (
            first.dtype == np.uint32
            and first.flags.c_contiguous
            and first.base is not None
        ):
            start = first.ctypes.data
            expect = start
            for u in units:
                a = np.asarray(u)
                if (
                    a.dtype != np.uint32
                    or not a.flags.c_contiguous
                    or a.ctypes.data != expect
                ):
                    break
                expect += a.nbytes
            else:
                flat = first  # keep a ref; pass `start` directly
        if flat is None:
            flat = np.ascontiguousarray(
                np.concatenate(
                    [np.asarray(u, dtype=np.uint32) for u in units]
                )
            )
        out_lens = np.zeros(len(units), dtype=np.int64)
        # Modest capacity (real DINT output is ~0.3-0.5 B/int; worst
        # case 6 B/int falls back to the exact-size retry below).
        # Oversizing is not free on this host: fresh footprint pays
        # ~20 MB/s cold faults on hosts with
        # hypervisor-backed memory).
        cap = int(int(offs[-1]) * 2 + len(units) * 8 + 64)
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.dint_encode_units(
            self._h, flat.ctypes.data, offs.ctypes.data, len(units), mode,
            out.ctypes.data, cap, out_lens.ctypes.data,
        )
        while n < 0:
            # -n is a lower bound on the bytes needed (the serial path
            # reports the overflow point, not the total) — grow past it
            # and past a doubling, and re-run (unit memoization makes
            # the retry pass cheap).
            cap = max(int(-n) + 64, cap * 2)
            out = np.empty(cap, dtype=np.uint8)
            n = self._lib.dint_encode_units(
                self._h, flat.ctypes.data, offs.ctypes.data, len(units), mode,
                out.ctypes.data, cap, out_lens.ctypes.data,
            )
        res: List[bytes] = []
        pos = 0
        buf = out[: int(n)].tobytes()
        for ln in out_lens:
            res.append(buf[pos : pos + int(ln)])
            pos += int(ln)
        return res


def native_encoder_for(d) -> Optional[NativeEncoder]:
    """Build a NativeEncoder from any dictionary object, or None."""
    if get_lib() is None:
        return None
    view = d.decode_view()
    if hasattr(d, "context_count"):
        counts = [d.context_count(c) for c in range(view.offsets.shape[0])]
    elif hasattr(d, "m_size"):
        counts = [d.m_size]
    else:
        counts = [d.size]
    return NativeEncoder(view, counts)
