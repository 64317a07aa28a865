"""ctypes bindings for the native zoo block decoders (host copy).

native/zoo_decode.cpp holds straight C++ selector walks over the same
wire formats the Python encoders emit — the host-CPU analogue of the
reference's unrolled-SSE decoders (block_codecs.hpp:232-506,
VarIntG8IU.h, varintgb.h).  It is compiled read-only into the port's
build directory (``libzoodec.so``) at first use; a library that does
not build raises with the compiler's message.  The numpy decoders in
blocks.py stay as the cross-checked oracle, and still take over when
the native walk refuses a buffer (truncated input, a buffer that is
not addressable without a copy): the native call then returns None.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils import nativebuild

_SO = "libzoodec.so"
_lib = None
_FUNCS = (
    "zoo_vbyte",
    "zoo_maskedvbyte",
    "zoo_streamvbyte",
    "zoo_varintgb",
    "zoo_varintg8iu",
    "zoo_simple16",
    "zoo_optpfor_block",
)


def get_lib():
    """The loaded library (built on first use); raises with the build
    error when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    src = nativebuild.source_path("zoo_decode.cpp")
    if src is None:
        raise RuntimeError("native/zoo_decode.cpp is required for the zoo "
                           "decoders")
    so = nativebuild.ensure_so(src, _SO)
    if so is None:
        raise RuntimeError(
            f"native zoo decoder library unavailable "
            f"({nativebuild.errors.get(_SO, 'build failed').strip()})")
    lib = ctypes.CDLL(so)
    for name in _FUNCS:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
    lib.zoo_many.restype = ctypes.c_int64
    lib.zoo_many.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.zoo_qmx.restype = ctypes.c_int64
    lib.zoo_qmx.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def _as_base(buf) -> Optional[Tuple[int, int]]:
    """(base_pointer, total_bytes) for a zero-copy addressable buffer,
    or None (callers fall back to the numpy decoders).  The pointer
    aliases memory owned by `buf`, which every caller keeps alive for
    the duration of the native call."""
    if isinstance(buf, np.ndarray):
        if buf.dtype != np.uint8 or not buf.flags.c_contiguous:
            return None
        return buf.ctypes.data, buf.shape[0]
    if isinstance(buf, (bytes, bytearray, memoryview)):
        a = np.frombuffer(buf, dtype=np.uint8)
        return a.ctypes.data, a.shape[0]
    return None


def qmx_decode(payload, n: int) -> Optional[np.ndarray]:
    """Decode a full QMX payload; None when the walk refuses the buffer
    (the caller falls back to numpy)."""
    lib = get_lib()
    if n <= 0:
        return None
    bt = _as_base(payload)
    if bt is None:
        return None
    base, total = bt
    if total <= 0:
        return None
    out = np.empty(n, dtype=np.uint32)
    used = lib.zoo_qmx(base, total, n, out.ctypes.data_as(ctypes.c_void_p))
    if used < 0:
        return None
    return out


# codec-name -> zoo_many id (order matches FNS in zoo_decode.cpp)
_ZOO_MANY_IDS = {
    "vbyte": 0,
    "maskedvbyte": 1,
    "streamvbyte": 2,
    "varintgb": 3,
    "varintg8iu": 4,
    "simple16": 5,
    "optpfor": 6,
    "interpolative": 7,
}


def decode_chunked(codec: str, buf, start: int, n: int, chunk: int
                   ) -> Optional[Tuple[np.ndarray, int]]:
    """Whole-list decode as one native call looping `chunk`-sized
    sub-blocks (the decode_list_zoo layout); (values, new_pos) or None.
    Callers must route partial FIXED_BLOCK tails (interpolative) to the
    Python path themselves."""
    lib = get_lib()
    cid = _ZOO_MANY_IDS.get(codec)
    if cid is None or n <= 0:
        return None
    bt = _as_base(buf)
    if bt is None:
        return None
    base, total = bt
    avail = total - start
    if avail <= 0:
        return None
    out = np.empty(n, dtype=np.uint32)
    used = lib.zoo_many(
        cid, base + start, avail, n, chunk,
        out.ctypes.data_as(ctypes.c_void_p))
    if used < 0:
        return None
    return out, start + int(used)


def decode(func_name: str, buf, pos: int, n: int
           ) -> Optional[Tuple[np.ndarray, int]]:
    """Decode n values at byte offset pos; (values, new_pos), or None
    when the walk refuses the input or buf isn't addressable without a
    copy (callers fall back to the numpy decoders)."""
    lib = get_lib()
    if n <= 0:
        return None
    bt = _as_base(buf)
    if bt is None:
        return None
    base, total = bt
    avail = total - pos
    if avail <= 0:
        return None
    out = np.empty(n, dtype=np.uint32)
    used = getattr(lib, func_name)(
        base + pos, avail, n, out.ctypes.data_as(ctypes.c_void_p))
    if used < 0:
        return None
    return out, pos + int(used)
