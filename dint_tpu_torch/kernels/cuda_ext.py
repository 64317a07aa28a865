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

from ..utils import nativebuild

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
}
_SOURCES = {"libdintgather.so": "decode_gather.cu",
            "libdintserve.so": "serve_gather.cu",
            "libdintprobe.so": "store_probe.cu",
            "libdintonehot.so": "onehot_gather.cu"}
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
    Raises with the compiler's message if the build fails."""
    src = os.path.join(CSRC, _SOURCES[so_name])
    out = os.path.join(nativebuild.build_dir(), so_name)
    if nativebuild.fresh(out, [src]):
        return out
    with nativebuild.locked(out + ".lock"):
        if nativebuild.fresh(out, [src]):
            return out
        if not nativebuild.compile_atomic([nvcc(), *NVCC_FLAGS, src], [src], out):
            raise RuntimeError(f"nvcc failed to build {so_name} from {src}")
    return out


def lib(so_name: str = "libdintgather.so") -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if so_name not in _libs:
        handle = ctypes.CDLL(build(so_name))
        for fn, argtypes in _SIGNATURES[so_name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        handle.dint_error_string.argtypes = [ctypes.c_int]
        handle.dint_error_string.restype = ctypes.c_char_p
        _libs[so_name] = handle
    return _libs[so_name]


def check(so_name: str, fn: str, rc: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib(so_name).dint_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} ({msg})")
