"""Vroom-style encoded stream container.

Main stream format is byte-compatible with the reference's vroom
environment (vroom_env/codecs.hpp header :110-124, encode.cpp:96-125):
per list, TightVByte(n) + TightVByte(universe) followed by the codec
payload, where universe = sum of the gap-transformed values.  The bpi
statistic counts exactly these bytes (dictionary excluded), matching
vroom_env/encode.cpp:38-58.

Device-decode addition: a skip sidecar (``<file>.skips.npz``) written by
the encoder records per-list payload offsets/lengths — and per-block
offsets for 256-blocked multi streams — so the device can decode every
unit in parallel instead of walking the stream sequentially.  The
reference has no sidecar because its decoder is sequential; ours is the
moral equivalent of the block_endpoints skip data its *index* format
stores (dict_posting_list.hpp:17-20).  Sidecar bytes are reported
separately from bpi, the same way the reference reports dictionary MiB
separately (vroom_env/decode.cpp:121-124).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..codecs import vbyte


@dataclass
class StreamMeta:
    n: np.ndarray  # (L,) u32 ints per list
    universe: np.ndarray  # (L,) u64 sum of gap values per list
    payload_off: np.ndarray  # (L,) u64 byte offset of codeword payload
    payload_len: np.ndarray  # (L,) u64 payload byte length
    block_off: Optional[np.ndarray] = None  # flat u64, multi streams only
    block_ptr: Optional[np.ndarray] = None  # (L+1,) u64 into block_off

    @property
    def num_lists(self) -> int:
        return int(self.n.shape[0])

    def sidecar_bytes(self) -> int:
        total = self.n.nbytes + self.universe.nbytes
        total += self.payload_off.nbytes + self.payload_len.nbytes
        if self.block_off is not None:
            total += self.block_off.nbytes + self.block_ptr.nbytes
        return total


def write_stream(
    path: str,
    payloads: Sequence[bytes],
    ns: Sequence[int],
    universes: Sequence[int],
    block_lens: Optional[Sequence[Sequence[int]]] = None,
) -> StreamMeta:
    """Write main stream + sidecar; returns the metadata."""
    L = len(payloads)
    n_arr = np.asarray(ns, dtype=np.uint32)
    u_arr = np.asarray(universes, dtype=np.uint64)
    off = np.zeros(L, dtype=np.uint64)
    plen = np.zeros(L, dtype=np.uint64)
    pos = 0
    with open(path, "wb") as f:
        for i, p in enumerate(payloads):
            hdr = vbyte.encode_single(int(n_arr[i])) + vbyte.encode_single(
                int(u_arr[i]) & 0xFFFFFFFF
            )
            f.write(hdr)
            pos += len(hdr)
            off[i] = pos
            plen[i] = len(p)
            f.write(p)
            pos += len(p)
    meta = StreamMeta(n_arr, u_arr, off, plen)
    if block_lens is not None:
        flat: List[int] = []
        ptr = [0]
        for i, bl in enumerate(block_lens):
            base = int(off[i])
            acc = base
            for blen in bl:
                flat.append(acc)
                acc += blen
            ptr.append(len(flat))
        meta.block_off = np.asarray(flat, dtype=np.uint64)
        meta.block_ptr = np.asarray(ptr, dtype=np.uint64)
    np.savez(
        path + ".skips.npz",
        n=meta.n,
        universe=meta.universe,
        payload_off=meta.payload_off,
        payload_len=meta.payload_len,
        **(
            {"block_off": meta.block_off, "block_ptr": meta.block_ptr}
            if meta.block_off is not None
            else {}
        ),
    )
    return meta


def load_stream(path: str) -> Tuple[np.ndarray, StreamMeta]:
    arena = np.fromfile(path, dtype=np.uint8)
    z = np.load(path + ".skips.npz")
    meta = StreamMeta(
        z["n"],
        z["universe"],
        z["payload_off"],
        z["payload_len"],
        z["block_off"] if "block_off" in z else None,
        z["block_ptr"] if "block_ptr" in z else None,
    )
    return arena, meta


def walk_stream_headers(arena: np.ndarray, num_lists: Optional[int] = None):
    """Sequential header walk (reference-style) — used to cross-check the
    sidecar and to import streams without one.  Requires a decoder to
    know payload lengths, so this yields (n, universe, payload_start)
    and the caller advances."""
    pos = 0
    out = []
    while pos < arena.shape[0] and (num_lists is None or len(out) < num_lists):
        n, pos = vbyte.decode_single(arena, pos)
        u, pos = vbyte.decode_single(arena, pos)
        out.append((n, u, pos))
        break  # cannot advance without decoding; caller drives
    return out


def stream_stats_line(
    kind: str, path: str, meta: StreamMeta, extra: Optional[dict] = None
) -> dict:
    size = os.path.getsize(path)
    total_ints = int(meta.n.astype(np.int64).sum())
    rec = {
        "filename": path,
        "num_sequences": str(meta.num_lists),
        "num_integers": str(total_ints),
        "type": kind,
        "GiB": f"{size / (1 << 30)}",
        "bpi": f"{size * 8.0 / max(total_ints, 1)}",
        "sidecar_bytes": str(meta.sidecar_bytes()),
        "sidecar_bpi": f"{meta.sidecar_bytes() * 8.0 / max(total_ints, 1)}",
    }
    if extra:
        rec.update(extra)
    return rec
