"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, in the port's build directory, at the
first call that needs it (never at import: the CPU tests import every
module).  The library is loaded with ctypes; every pointer and the
stream pass as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from ..utils import nativebuild, trace

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_SIGNATURES = {
    "libdintgather.so": {
        # vidx, tab, n, salt, out, rows, n_out, stream
        "dint_gather32": [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P],
        "dint_gather16": [_P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int, _P],
        # n, salt, out, rows, n_out, stream
        "dint_zero": [_P, _P, _P, ctypes.c_int64, ctypes.c_int, _P],
        # n0, rows0, vidx16, tab16, n16, rows16, vidx32, tab32, n32, rows32,
        # salt, out, n_out, exact, stream
        "dint_decode_classes": [_P, ctypes.c_int64, _P, _P, _P, ctypes.c_int64,
                                _P, _P, _P, ctypes.c_int64, _P, _P,
                                ctypes.c_int, ctypes.c_int, _P],
        # blocks, stream
        "dint_empty_launch": [ctypes.c_int64, _P],
    },
    "libdintserve.so": {
        # blk, qw, dstore, wstore, dout, sout, G, NB, stream
        "dint_block_copy": [_P, _P, _P, _P, _P, _P, ctypes.c_int64,
                            ctypes.c_int64, _P],
    },
    "libdintprobe.so": {
        # salt, out, rows, row_tile, stream
        "dint_store_tile": [_P, _P, ctypes.c_int64, ctypes.c_int, _P],
    },
    "libdintonehot.so": {
        # vidx, tab, n, salt, out, rows, stream
        "dint_onehot_block": [_P, _P, _P, _P, _P, ctypes.c_int64, _P],
        "dint_onehot_group": [_P, _P, _P, _P, _P, ctypes.c_int64, _P],
    },
    "libdintladder.so": {
        # host class table, classes, salt, stream
        "dint_ladder_unpack": [_P, ctypes.c_int, _P, _P],
        # host class table, classes, stream
        "dint_ladder_rows": [_P, ctypes.c_int, _P],
    },
    "libdintef.so": {
        # high, counts, B, NW, stream
        "dint_ef_count": [_P, _P, ctypes.c_int64, ctypes.c_int64, _P],
        # words, high, starts, block_list, lists, incl, counts, out, B, NW,
        # stream
        "dint_ef_decode": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64,
                           ctypes.c_int64, _P],
    },
    "libdintraw.so": {
        # tokens, rows, items, n_items, lengths, offsets, table, E, T, val,
        # produced, consumed, stream
        "dint_raw_pass": [_P, _P, _P, ctypes.c_int64, _P, _P, _P,
                          ctypes.c_int, ctypes.c_int64, _P, _P, _P, _P],
    },
    "libdintbyte.so": {
        # host class table, classes, group_bits, salt, stream
        "dint_byteclass_unpack": [_P, ctypes.c_int, ctypes.c_int, _P, _P],
    },
}
_SOURCES = {"libdintgather.so": "decode_gather.cu",
            "libdintserve.so": "serve_gather.cu",
            "libdintprobe.so": "store_probe.cu",
            "libdintonehot.so": "onehot_gather.cu",
            "libdintladder.so": "ladder_unpack.cu",
            "libdintef.so": "ef_decode.cu",
            "libdintraw.so": "raw_decode.cu",
            "libdintbyte.so": "byteclass_unpack.cu"}
LIBRARIES = tuple(_SOURCES)
_libs = {}


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(so_name: str) -> str:
    """Compile ``so_name`` from its source if stale; return its path.
    Raises with the compiler's message if the build fails.  The check and
    any compile are the span ``lib.build``."""
    src = os.path.join(CSRC, _SOURCES[so_name])
    out = os.path.join(nativebuild.build_dir(), so_name)
    with trace.span("lib.build"):
        if nativebuild.fresh(out, [src]):
            return out
        with nativebuild.locked(out + ".lock"):
            if nativebuild.fresh(out, [src]):
                return out
            if not nativebuild.compile_atomic([nvcc(), *NVCC_FLAGS, src],
                                              [src], out):
                raise RuntimeError(f"nvcc failed to build {out} from {src}")
        return out


def _bind(path: str, signatures) -> ctypes.CDLL:
    handle = ctypes.CDLL(path)
    for fn, argtypes in signatures.items():
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    handle.dint_error_string.argtypes = [ctypes.c_int]
    handle.dint_error_string.restype = ctypes.c_char_p
    return handle


def lib(so_name: str = "libdintgather.so") -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if so_name not in _libs:
        _libs[so_name] = _bind(build(so_name), _SIGNATURES[so_name])
    return _libs[so_name]


def check(so_name: str, fn: str, rc: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib(so_name).dint_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
