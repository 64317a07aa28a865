"""Tight variable-byte codec.

Byte-compatible with the reference's ``TightVariableByte``
(block_codecs.hpp:20-102): little-endian 7-bit groups, the HIGH bit set
marks the LAST byte of a value (note: inverted vs. the common
continuation-bit convention).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def encode_single(val: int) -> bytes:
    out = bytearray()
    v = int(val) & 0xFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v == 0:
            out.append(b | 0x80)
            return bytes(out)
        out.append(b)


def encode(values: np.ndarray) -> bytes:
    out = bytearray()
    for v in np.asarray(values, dtype=np.uint64):
        out += encode_single(int(v))
    return bytes(out)


def _decode_scalar(buf, pos: int, n: int) -> Tuple[np.ndarray, int]:
    """Byte-walk oracle (cross-checked against the vectorized decode)."""
    vals = np.empty(n, dtype=np.uint32)
    for i in range(n):
        v = 0
        shift = 0
        while True:
            c = int(buf[pos])  # buf may be a numpy u8 array
            pos += 1
            v += (c & 0x7F) << shift
            if c & 0x80:
                break
            shift += 7
        vals[i] = v & 0xFFFFFFFF
    return vals, pos


def decode(buf, pos: int, n: int) -> Tuple[np.ndarray, int]:
    """Decode n values starting at byte offset pos; returns
    (values, new_pos).  Vectorized: the format is self-delimiting (the
    HIGH bit marks a value's LAST byte), so the first n marked bytes
    are the value boundaries and lanes assemble with masked gathers."""
    if n == 0:
        return np.zeros(0, np.uint32), pos
    if n < 8:
        return _decode_scalar(buf, pos, n)
    raw = buf[pos : pos + 5 * n]
    if isinstance(raw, (bytes, bytearray, memoryview)):
        data = np.frombuffer(raw, dtype=np.uint8)
    else:
        data = np.asarray(raw, dtype=np.uint8)
    data = np.concatenate([data, np.zeros(8, np.uint8)])
    term = np.flatnonzero((data & 0x80) != 0)
    ends = term[:n].astype(np.int64)
    starts = np.concatenate([[0], ends[:-1] + 1])
    L = ends - starts + 1
    v = np.zeros(n, np.uint64)
    for i in range(5):
        m = L > i
        if not m.any():
            break
        v[m] += (
            data[starts[m] + i].astype(np.uint64) & np.uint64(0x7F)
        ) << np.uint64(7 * i)
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), pos + int(ends[-1]) + 1


def decode_single(buf, pos: int) -> Tuple[int, int]:
    vals, pos = decode(buf, pos, 1)
    return int(vals[0]), pos


def encoded_size(val: int) -> int:
    v = int(val)
    n = 1
    while v >= 1 << 7:
        v >>= 7
        n += 1
    return n
