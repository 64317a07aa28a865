"""Bit-level building blocks for the Elias-Fano sequence family (host
copy of ``dint_tpu/utils/bitio.py``).

Numpy-vectorized equivalent of succinct::bit_vector_builder: a growable
little-endian bit stream (bit k of the stream is bit k%64 of word
k//64) supporting sequential appends, random-access field writes into a
pre-extended region (the EF writers' pattern, compact_elias_fano.hpp:
69-136), and vectorized strided field reads for whole-sequence decode.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_W = 64


class BitBuilder:
    def __init__(self):
        self._words = np.zeros(16, dtype=np.uint64)
        self._bits = 0

    @property
    def size(self) -> int:
        return self._bits

    def _ensure(self, bits: int) -> None:
        need = (bits + _W - 1) // _W
        if need > self._words.shape[0]:
            cap = max(need, self._words.shape[0] * 2)
            w = np.zeros(cap, dtype=np.uint64)
            w[: self._words.shape[0]] = self._words
            self._words = w

    def zero_extend(self, n: int) -> None:
        self._ensure(self._bits + n)
        self._bits += n

    def append_bits(self, value: int, length: int) -> None:
        if length == 0:
            return
        assert 0 <= value < (1 << length)
        self._ensure(self._bits + length)
        set_bits_scalar(self._words, self._bits, value, length)
        self._bits += length

    def set(self, pos: int, bit: int) -> None:
        assert pos < self._bits
        if bit:
            self._words[pos // _W] |= np.uint64(1 << (pos % _W))

    def set_bits(self, pos: int, value: int, length: int) -> None:
        assert pos + length <= self._bits
        set_bits_scalar(self._words, pos, value, length)

    def set_bits_batch(self, positions: np.ndarray, values: np.ndarray,
                       width: int) -> None:
        """Vectorized fixed-width field writes at arbitrary bit positions.

        Fields must be disjoint and land in zero bits (the EF write
        pattern after zero_extend)."""
        if width == 0 or positions.shape[0] == 0:
            return
        pos = positions.astype(np.uint64)
        val = values.astype(np.uint64)
        if width < _W:
            assert (val < (np.uint64(1) << np.uint64(width))).all()
        wi = (pos // _W).astype(np.int64)
        sh = pos % _W
        lo = val << sh
        np.bitwise_or.at(self._words, wi, lo)
        spill = sh + width > _W
        if spill.any():
            hi = (val[spill] >> (np.uint64(_W) - sh[spill]))
            np.bitwise_or.at(self._words, wi[spill] + 1, hi)

    def set_ones(self, positions: np.ndarray) -> None:
        pos = positions.astype(np.uint64)
        np.bitwise_or.at(
            self._words, (pos // _W).astype(np.int64),
            np.uint64(1) << (pos % _W),
        )

    def append(self, other: "BitBuilder") -> None:
        self._ensure(self._bits + other._bits + _W)  # +_W: unaligned spill
        if other._bits == 0:
            return
        if self._bits % _W == 0:
            w0 = self._bits // _W
            nw = (other._bits + _W - 1) // _W
            self._words[w0 : w0 + nw] |= other._words[:nw]
            self._bits += other._bits
            return
        # unaligned append: shift other's words
        sh = np.uint64(self._bits % _W)
        nw = (other._bits + _W - 1) // _W
        src = other._words[:nw]
        w0 = self._bits // _W
        with np.errstate(over="ignore"):
            lo = src << sh
            hi = src >> (np.uint64(_W) - sh)
        self._words[w0 : w0 + nw] |= lo
        self._words[w0 + 1 : w0 + 1 + nw] |= hi
        self._bits += other._bits

    def words(self) -> np.ndarray:
        n = (self._bits + _W - 1) // _W
        return self._words[: max(n, 1)].copy()


def set_bits_scalar(words: np.ndarray, pos: int, value: int, length: int) -> None:
    value = int(value)
    wi, sh = divmod(pos, _W)
    words[wi] |= np.uint64((value << sh) & 0xFFFFFFFFFFFFFFFF)
    if sh + length > _W:
        words[wi + 1] |= np.uint64(value >> (_W - sh))


class BitReader:
    """Sequential reader (for gamma/delta headers)."""

    def __init__(self, words: np.ndarray, pos: int = 0):
        self.words = words
        self.pos = pos

    def take(self, length: int) -> int:
        v = read_bits_scalar(self.words, self.pos, length)
        self.pos += length
        return v

    def skip_zeros(self) -> int:
        """Count and skip zeros up to the next 1, consuming it."""
        start = self.pos
        while True:
            wi, sh = divmod(self.pos, _W)
            word = int(self.words[wi]) >> sh
            if word == 0:
                self.pos += _W - sh
                continue
            z = (word & -word).bit_length() - 1
            self.pos += z + 1
            return self.pos - start - 1


def read_bits_scalar(words: np.ndarray, pos: int, length: int) -> int:
    if length == 0:
        return 0
    wi, sh = divmod(pos, _W)
    lo = int(words[wi]) >> sh
    if sh + length > _W:
        lo |= int(words[wi + 1]) << (_W - sh)
    return lo & ((1 << length) - 1)


def read_fields(words: np.ndarray, positions: np.ndarray, width: int) -> np.ndarray:
    """Vectorized fixed-width field reads at arbitrary bit positions."""
    if width == 0:
        return np.zeros(positions.shape[0], dtype=np.uint64)
    pos = positions.astype(np.uint64)
    wi = (pos // _W).astype(np.int64)
    sh = pos % _W
    with np.errstate(over="ignore"):
        lo = words[wi] >> sh
        spill = (sh + width > _W) & (wi + 1 < words.shape[0])
        hi = np.zeros_like(lo)
        hi[spill] = words[wi[spill] + 1] << (np.uint64(_W) - sh[spill])
    v = lo | hi
    if width < _W:
        v &= (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return v


def ones_positions(words: np.ndarray, start: int, end: int) -> np.ndarray:
    """Positions (relative to `start`) of 1 bits in [start, end)."""
    if end <= start:
        return np.zeros(0, dtype=np.int64)
    w0, w1 = start // _W, (end + _W - 1) // _W
    chunk = words[w0:w1]
    bits = np.unpackbits(chunk.view(np.uint8), bitorder="little")
    lo = start - w0 * _W
    return np.flatnonzero(bits[lo : lo + (end - start)]).astype(np.int64)


def ceil_log2(x: int) -> int:
    return (int(x) - 1).bit_length() if x > 1 else 0
