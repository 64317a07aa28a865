"""Whole-list vroom encoding for the non-DINT codec types (host copy
of ``dint_tpu/index/vroom_zoo.py``, held equal by a test).

Reference vroom_env/codecs.hpp wraps each codec for whole lists (no
256-int index blocking) plus a whole-list partitioned-Elias-Fano type
(:471-509).  Here each gap list is encoded per OPT_CHUNK sub-block for
the fixed-block codecs and natively otherwise; `pef` encodes the
docID sequence itself (not gaps) with partitioned EF.  Streams reuse
the sidecar container (index/stream.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..codecs import blocks as blocks_mod
from ..codecs import ef
from ..codecs.encode_batch import OPT_CHUNK
from ..config import BLOCK_SIZE
from ..utils import gaps as gap_mod
from ..utils.bitio import BitBuilder

FIXED_BLOCK = ("optpfor", "varintg8iu", "interpolative")  # 256-chunked


def encode_list_zoo(codec: str, gaps: np.ndarray) -> Tuple[bytes, List[int]]:
    """(payload, chunk byte lengths) for one gap list."""
    if codec == "qmx":
        # whole-list QMX, exactly the reference's vroom wrapper
        # (codecs.hpp:333-347): n == 1 is a bare vbyte, else
        # TightVariableByte(len) + one QMX payload for the full list.
        from ..codecs import qmx as qmx_wire
        from ..codecs import vbyte

        if gaps.shape[0] == 1:
            part = vbyte.encode_single(int(gaps[0]))
        else:
            payload = qmx_wire.encode(gaps)
            part = vbyte.encode_single(len(payload)) + payload
        return part, [len(part)]
    enc = blocks_mod.CODECS[codec][0]
    chunk = BLOCK_SIZE if codec in FIXED_BLOCK else OPT_CHUNK
    parts = []
    for p in range(0, max(1, gaps.shape[0]), chunk):
        sub = gaps[p : p + chunk]
        parts.append(enc(sub, blocks_mod.UNKNOWN))
    return b"".join(parts), [len(x) for x in parts]


def decode_list_zoo(codec: str, arena, start: int, n: int) -> np.ndarray:
    if codec == "qmx":
        from ..codecs import qmx as qmx_wire
        from ..codecs import vbyte

        if n == 1:
            val, _ = vbyte.decode_single(arena, start)
            return np.asarray([val], np.uint32)
        ln, pos = vbyte.decode_single(arena, start)
        return qmx_wire.decode_payload(
            np.asarray(arena[pos : pos + ln], dtype=np.uint8), n
        )
    dec = blocks_mod.CODECS[codec][1]
    chunk = BLOCK_SIZE if codec in FIXED_BLOCK else OPT_CHUNK
    # native whole-list fast path: one call loops the chunks in C++
    # (partial FIXED_BLOCK tails divert to interpolative, so the
    # native call covers only the full chunks there)
    from ..codecs import zoonative

    # interpolative's own partial tail IS interpolative — native covers
    # the whole list; the other FIXED_BLOCK codecs divert their tails
    n_native = (n // chunk) * chunk \
        if (codec in FIXED_BLOCK and codec != "interpolative") else n
    if n_native:
        r = zoonative.decode_chunked(codec, arena, start, n_native, chunk)
        if r is not None:
            head, pos = r
            if n_native == n:
                return head
            tail, _ = dec(arena, pos, n - n_native, blocks_mod.UNKNOWN)
            return np.concatenate([head, tail])
    out = np.empty(n, dtype=np.uint32)
    pos = start
    for p in range(0, n, chunk):
        size = min(chunk, n - p)
        vals, pos = dec(arena, pos, size, blocks_mod.UNKNOWN)
        out[p : p + size] = vals
    return out


def encode_list_pef(docs: np.ndarray) -> bytes:
    """Whole-list partitioned EF over the docID sequence
    (vroom_env/codecs.hpp pef :471-509 capability)."""
    seq = ef.partitioned_sequence(ef.indexed_sequence)
    bb = BitBuilder()
    universe = int(docs[-1]) + 1
    seq.write(bb, docs, universe, docs.shape[0], ef.PARAMS)
    return bb.words().tobytes(), bb.size


def decode_list_pef(arena, start: int, byte_len: int, n: int,
                    universe: int) -> np.ndarray:
    raw = bytes(arena[start : start + byte_len])
    pad = (-len(raw)) % 8
    words = np.frombuffer(raw + b"\x00" * pad, dtype=np.uint64)
    seq = ef.partitioned_sequence(ef.indexed_sequence)
    return seq.decode_all(words, 0, universe, n, ef.PARAMS)
