"""The hosted-vidx gather as an int8 one-hot matrix product (K6, K7).

The counterpart of the reference package's ``kernels/decode_pallas.py``
(the module name is kept so a reader finds it): the same function as K1,
``out[r, j] = table[r, vidx[r, j]]`` for ``j < n[r]``, computed not by
indexing but as a tensor-core product of the table's four byte planes
with a one-hot selector built from ``vidx`` inside the kernel
(``csrc/onehot_gather.cu``).  Nothing on the decode or serving paths
calls it; it exists for the ablation (``tools/kernel_ablate.py``), which
times this form against the plain gather.

``decode_gather_pallas`` (K6) gives a thread block ``ROW_BLOCK`` rows,
``decode_gather_pallas_grid`` (K7) one ``G``-row group; both run the
same kernel body and equal ``decode_local.decode_gather_rows``, their
plain PyTorch version, bit for bit.  The wrappers dispatch on the
tensors' device: a CUDA tensor goes to the kernel (or the call raises),
a CPU tensor to the plain version; nothing falls back.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import cuda_ext
from .decode_local import N_OUT, TABLE_CLS, decode_gather_rows

ROW_BLOCK = 256  # rows per K6 thread block
G = 8  # rows per K7 thread block (one per warp)

_LIB = "libdintonehot.so"


def _onehot(name, fn, vidx, table, n, salt):
    R = vidx.shape[0]
    for label, a, shape in (("vidx", vidx, (R, N_OUT)),
                            ("table", table, (R, TABLE_CLS)),
                            ("n", n, (R,))):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"{name}: {label} must be {shape} int32, got "
                             f"{tuple(a.shape)} {a.dtype}")
    if N_OUT != 256 or TABLE_CLS != 256:
        raise ValueError(f"{name}: the kernel is built for 256 outputs and "
                         f"256 table entries a row, not {N_OUT}/{TABLE_CLS}")
    if salt.dtype != torch.int64 or salt.numel() != 1:
        raise ValueError(f"{name}: salt must be a 1-element int64 tensor")
    dev = vidx.device
    if not (table.device == n.device == salt.device == dev):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return decode_gather_rows(vidx, table, n, salt)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    out = torch.empty((R, N_OUT), dtype=torch.int32, device=dev)
    for t in (vidx, table, n, salt, out):
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    for t in (vidx, table, out):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: vidx, table and out must be 16-byte "
                             "aligned")
    if R == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(cuda_ext.lib(_LIB), fn)(
        vidx.data_ptr(), table.data_ptr(), n.data_ptr(), salt.data_ptr(),
        out.data_ptr(), R, stream,
    )
    cuda_ext.check(_LIB, fn, rc)
    return out


def decode_gather_pallas(vidx, table, n, salt):
    """K6.  vidx (R, N_OUT) int32; table (R, TABLE_CLS) int32 (u32
    bits); n (R,) int32; salt (1,) int64 holding a u32 value.  Returns
    (R, N_OUT) int32 (u32 bits).  R must be a multiple of ROW_BLOCK."""
    R = vidx.shape[0]
    if R % ROW_BLOCK:
        raise ValueError(f"decode_gather_pallas: {R} rows, not a multiple "
                         f"of {ROW_BLOCK}")
    out = _onehot("decode_gather_pallas", "dint_onehot_block", vidx, table,
                  n, salt)
    if out.is_cuda and R:
        decode_gather_pallas.launches += 1
    return out


def decode_gather_pallas_grid(vidx, table, n, salt):
    """K7, the grid variant: one thread block per G-row group.  Same
    arguments; R must be a multiple of G."""
    R = vidx.shape[0]
    if R % G:
        raise ValueError(f"decode_gather_pallas_grid: {R} rows, not a "
                         f"multiple of {G}")
    out = _onehot("decode_gather_pallas_grid", "dint_onehot_group", vidx,
                  table, n, salt)
    if out.is_cuda and R:
        decode_gather_pallas_grid.launches += 1
    return out


decode_gather_pallas.launches = 0
decode_gather_pallas_grid.launches = 0

KERNELS = {"K6_onehot_block": decode_gather_pallas,
           "K7_onehot_group": decode_gather_pallas_grid}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}
