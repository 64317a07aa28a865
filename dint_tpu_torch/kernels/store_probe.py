"""Pure device-memory store-bandwidth probe.

Every decode engine here materializes u32 output, so the speed of light
for "decoded ints/s" is bounded by how fast the card can WRITE the
output array alone.  This probe measures exactly that under the same
chained, salted protocol as the decode benchmarks (``tools/bench.py``):
a kernel whose only work is writing a salt-derived pattern over an
output array of the requested size (K5, ``csrc/store_probe.cu``),
chained ``runs`` times with each run's salt fed from a tiny dependent
read of the previous output.  The salt stays a device tensor
throughout, so no run waits for the host.

The reported GB/s beside a decode rate answers "how close to the store
wall is this engine": ints/s * 4 B / store_GBps = the share of the
pure-store speed of light spent on output writes alone.

``store_tile`` dispatches on the salt tensor's device: the CUDA kernel
on a CUDA tensor (or the call raises), the plain PyTorch version on a
CPU tensor; nothing falls back.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..backend import resolve_device
from . import cuda_ext

ROW_LANES = 256
CHAIN_FEED_ROWS = 128  # rows of each run's output that feed the next salt

_LIB = "libdintprobe.so"
_MASK = 0xFFFFFFFF


def salt_tensor(value: int, device) -> torch.Tensor:
    """(1,) int32 tensor holding the u32 ``value``'s bits."""
    v = value & _MASK
    return torch.tensor([v - (1 << 32) if v >= 1 << 31 else v],
                        dtype=torch.int32, device=device)


def store_tile_plain(salt: torch.Tensor, rows: int,
                     row_tile: int = 1024) -> torch.Tensor:
    """K5's plain version: out[r, l] = l + 7 * (r % row_tile) + salt +
    r // row_tile in wrapping int32 (computed in int64 and masked)."""
    dev = salt.device
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    lane = torch.arange(ROW_LANES, dtype=torch.int64, device=dev)[None, :]
    v = (lane + 7 * (r % row_tile) + salt.to(torch.int64) + r // row_tile)
    v = v & _MASK
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def store_tile(salt: torch.Tensor, rows: int, row_tile: int = 1024,
               out: torch.Tensor = None) -> torch.Tensor:
    """K5: the (rows, 256) int32 probe pattern for ``salt`` ((1,) int32),
    tiles of ``row_tile`` rows.  ``out`` (optional) receives it in place.
    On a CUDA salt it launches the CUDA kernel (or raises); on a CPU salt
    it runs the plain version."""
    dev = salt.device
    if salt.dtype != torch.int32 or salt.numel() != 1:
        raise ValueError("store_tile: salt must be a 1-element int32 tensor")
    if rows < 0 or row_tile <= 0 or rows % row_tile:
        raise ValueError(f"store_tile: rows {rows} must be a multiple of "
                         f"row_tile {row_tile}")
    if out is None:
        out = torch.empty((rows, ROW_LANES), dtype=torch.int32, device=dev)
    elif (out.dtype != torch.int32 or tuple(out.shape) != (rows, ROW_LANES)
          or out.device != dev):
        raise ValueError(f"store_tile: out must be ({rows}, {ROW_LANES}) "
                         f"int32 on {dev}")
    if dev.type == "cpu":
        out.copy_(store_tile_plain(salt, rows, row_tile))
        return out
    if dev.type != "cuda":
        raise ValueError(f"store_tile: unsupported device {dev}")
    if not (out.is_contiguous() and salt.is_contiguous()):
        raise ValueError("store_tile: every tensor must be contiguous")
    if out.data_ptr() % 16:
        raise ValueError("store_tile: out must be 16-byte aligned")
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_ext.lib(_LIB).dint_store_tile(
        salt.data_ptr(), out.data_ptr(), rows, row_tile, stream)
    cuda_ext.check(_LIB, "dint_store_tile", rc)
    store_tile.launches += 1
    return out


store_tile.launches = 0

KERNELS = {"K5_store_tile": store_tile}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


def probe_rows(total_bytes: int, row_tile: int = 1024) -> int:
    """Rows of the probe output for ``total_bytes``: at least one tile,
    rounded down to whole tiles."""
    rows = max(total_bytes // (4 * ROW_LANES), row_tile)
    return (rows // row_tile) * row_tile


def probe_chain(rows: int, row_tile: int, runs: int, device) -> torch.Tensor:
    """``runs`` chained probe writes from salt 1; each run's salt is the
    wrapping int32 sum of the first 128 rows of the previous output, plus
    the previous salt, plus 1.  Returns the final salt, a (1,) int32
    device tensor."""
    salt = salt_tensor(1, device)
    out = torch.empty((rows, ROW_LANES), dtype=torch.int32, device=device)
    for _ in range(runs):
        store_tile(salt, rows, row_tile, out=out)
        salt = out[:CHAIN_FEED_ROWS].sum(dtype=torch.int32) + salt + 1
    return salt


def probe_store_gbps(total_bytes: int = 64 << 20, runs: int = 2000,
                     row_tile: int = 1024, device="cuda") -> float:
    """Measured pure-store bandwidth in GB/s for an output of
    ``total_bytes`` (default 64 MiB, the bench stream's output size
    class), chained ``runs`` times after a 2-run warm-up.  On the card
    the chain is timed with CUDA events, on the CPU with the host
    clock."""
    dev = resolve_device(device)
    rows = probe_rows(total_bytes, row_tile)
    probe_chain(rows, row_tile, 2, dev).item()  # build + warm
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        salt = probe_chain(rows, row_tile, runs, dev)
        end.record()
        end.synchronize()
        salt.item()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        probe_chain(rows, row_tile, runs, dev).item()
        dt = time.perf_counter() - t0
    return rows * ROW_LANES * 4 * runs / dt / 1e9
