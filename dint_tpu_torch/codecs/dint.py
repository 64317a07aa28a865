"""DINT codeword codecs — scalar oracle implementations (host copy).

The port's own copy of ``dint_tpu/codecs/dint.py``; a test holds it
equal to the reference package's.  These are the executable specification of the DINT stream semantics,
mirrored from the reference:

* decode: vroom_env/dint_codecs.hpp single_dint::decode (:37-107) and
  multi_opt_dint::decode (:520-619) — u16 (b=16) or u8 (b=8) codeword
  streams; index >= 2 copies a dictionary entry, index 1 is an inline
  4-byte exception, index 0 a 2-byte exception.
* greedy encode: single_greedy_dint (:109-188) — longest zero-run
  first, then target sizes 16..1, else exception.
* optimal encode: single_opt_dint (:190-330) — shortest-path DP over
  positions with run edges (256..16), dictionary-hit edges per target
  size, and exception edges of cost 2 (value < 2^16) or 3; ties keep
  the first writer (strict '>' relaxation at :223-224,238-239).
* multi: multi_opt_dint (:332-518) — each 256-int chunk is trial-
  encoded under all NUM_SELECTORS contexts x {b=16, b=8}, the smallest
  byte-size wins, and a selector byte (sc, or sc+NUM_SELECTORS for
  b=8) prefixes the chunk.

The DP cost unit is codewords, so for b=8 the reference cost model
underestimates exception bytes; the final trial comparison uses real
byte sizes.  We mirror both behaviors for bpi parity.

Batched/TPU implementations (encode_batch.py, kernels/) are validated
against these oracles.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import (
    BLOCK_SIZE,
    EXCEPTIONS,
    MAX_ENTRY_SIZE,
    NUM_SELECTORS,
    SMALL_EXCEPTION_LIMIT,
    TARGET_SIZES,
)
from ..dictionary.dictionary import DecodeView, LookupTable


# ---------------------------------------------------------------------------
# Decode oracles
# ---------------------------------------------------------------------------


def decode_single(
    view: DecodeView,
    data,
    pos: int,
    n: int,
    out: np.ndarray,
    out_pos: int = 0,
    b: int = 16,
    context: int = 0,
) -> int:
    """Decode n ints at byte offset pos into out[out_pos:]; returns new pos.

    ``out`` must be zero-initialized over the target range (run entries
    copy only their leading 16 zeros, like the reference memcpy).
    """
    table = view.table
    offsets = view.offsets[context]
    lengths = view.lengths[context]
    i = 0
    while i != n:
        if b == 16:
            index = int(data[pos]) | (int(data[pos + 1]) << 8)
            pos += 2
        else:
            index = int(data[pos])
            pos += 1
        if index > EXCEPTIONS - 1:
            ln = int(lengths[index])
            off = int(offsets[index])
            m = min(ln, MAX_ENTRY_SIZE)
            out[out_pos : out_pos + m] = table[off : off + m]
            out_pos += ln
            i += ln
        elif index == 1:  # 4-byte exception
            v = (
                int(data[pos])
                | (int(data[pos + 1]) << 8)
                | (int(data[pos + 2]) << 16)
                | (int(data[pos + 3]) << 24)
            )
            pos += 4
            out[out_pos] = v
            out_pos += 1
            i += 1
        else:  # 2-byte exception
            v = int(data[pos]) | (int(data[pos + 1]) << 8)
            pos += 2
            out[out_pos] = v
            out_pos += 1
            i += 1
    return pos


def decode_multi(view: DecodeView, data, pos: int, n: int, out: np.ndarray) -> int:
    """multi_opt_dint::decode — 256-int chunks with selector bytes."""
    out_pos = 0
    remaining = n
    while remaining > 0:
        size = min(BLOCK_SIZE, remaining)
        sc = int(data[pos])
        pos += 1
        if sc < NUM_SELECTORS:
            pos = decode_single(view, data, pos, size, out, out_pos, 16, sc)
        else:
            pos = decode_single(
                view, data, pos, size, out, out_pos, 8, sc - NUM_SELECTORS
            )
        out_pos += size
        remaining -= size
    return pos


# ---------------------------------------------------------------------------
# Encode helpers
# ---------------------------------------------------------------------------


def _write_index(out: bytearray, index: int, b: int) -> None:
    out.append(index & 0xFF)
    if b == 16:
        out.append((index >> 8) & 0xFF)


def _write_exception(out: bytearray, value: int, b: int) -> None:
    if value < SMALL_EXCEPTION_LIMIT:
        _write_index(out, 0, b)
        out += int(value).to_bytes(2, "little")
    else:
        _write_index(out, 1, b)
        out += int(value).to_bytes(4, "little")


def zero_run_length(gaps: np.ndarray, i: int, cap: int) -> int:
    k = 0
    n = gaps.shape[0]
    while k < cap and i + k < n and gaps[i + k] == 0:
        k += 1
    return k


# ---------------------------------------------------------------------------
# Greedy single-dictionary encoder
# ---------------------------------------------------------------------------


def encode_greedy_single(lookup: LookupTable, gaps: np.ndarray, b: int = 16) -> bytes:
    out = bytearray()
    n = int(gaps.shape[0])
    i = 0
    while i < n:
        run_cap = min(256, n - i)
        lrs = zero_run_length(gaps, i, run_cap)
        if lrs >= 16:
            k = 256
            index = EXCEPTIONS
            while lrs < k and k > 16:
                index += 1
                k //= 2
            _write_index(out, index, b)
            i += k
        else:
            hit = -1
            step = 0
            for s in TARGET_SIZES:
                ln = min(s, n - i)
                hit = lookup.lookup_one(gaps[i : i + ln])
                if hit >= 0:
                    step = ln
                    break
            if hit >= 0:
                _write_index(out, hit, b)
                i += step
            else:
                _write_exception(out, int(gaps[i]), b)
                i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Optimal (shortest-path DP) encoder
# ---------------------------------------------------------------------------


def _run_edges(lrs: int) -> List[Tuple[int, int]]:
    """[(k, codeword_index), ...] run edges available for zero-run lrs >= 16.

    Reference loop (single_opt_dint :215-230): find the largest
    power-of-two k in [16, 256] with k <= lrs, then add edges for
    k, k/2, .., 16 with codeword indexes continuing to increment.
    """
    edges = []
    k = 256
    index = EXCEPTIONS
    while lrs < k and k > 16:
        k //= 2
        index += 1
    while k >= 16:
        edges.append((k, index))
        k //= 2
        index += 1
    return edges


def opt_parse(
    lookup: LookupTable, gaps: np.ndarray, b: int = 16
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the DP; returns (parent, codeword, cost) arrays of length n+1."""
    n = int(gaps.shape[0])
    parent = np.zeros(n + 1, dtype=np.int64)
    codeword = np.ones(n + 1, dtype=np.int64)
    cost = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        parent[i] = i - 1
        cost[i] = 3 * i
    for i in range(n):
        run_cap = min(256, n - i)
        lrs = zero_run_length(gaps, i, run_cap)
        if lrs >= 16:
            for k, index in _run_edges(lrs):
                c = cost[i] + 1
                if cost[i + k] > c:
                    parent[i + k] = i
                    codeword[i + k] = index
                    cost[i + k] = c
        for s in TARGET_SIZES:
            ln = min(s, n - i)
            hit = lookup.lookup_one(gaps[i : i + ln])
            if hit >= 0:
                c = cost[i] + 1
                if cost[i + ln] > c:
                    parent[i + ln] = i
                    codeword[i + ln] = hit
                    cost[i + ln] = c
            elif s == 1:
                v = int(gaps[i])
                c = cost[i] + 2
                idx = 0
                if v > SMALL_EXCEPTION_LIMIT - 1:
                    c += 1
                    idx = 1
                if cost[i + 1] > c:
                    parent[i + 1] = i
                    codeword[i + 1] = idx
                    cost[i + 1] = c
    return parent, codeword, cost


def emit_from_parse(
    parent: np.ndarray, codeword: np.ndarray, gaps: np.ndarray, b: int
) -> bytes:
    """Backtrack the DP path and emit the codeword stream."""
    n = int(gaps.shape[0])
    segs: List[Tuple[int, int]] = []  # (start, codeword)
    i = n
    while i != 0:
        p = int(parent[i])
        segs.append((p, int(codeword[i])))
        i = p
    segs.reverse()
    out = bytearray()
    for start, cw in segs:
        if cw > 1:
            _write_index(out, cw, b)
        else:
            _write_exception(out, int(gaps[start]), b)
    return bytes(out)


def encode_opt_single(lookup: LookupTable, gaps: np.ndarray, b: int = 16) -> bytes:
    parent, codeword, _ = opt_parse(lookup, gaps, b)
    return emit_from_parse(parent, codeword, gaps, b)


# ---------------------------------------------------------------------------
# Multi-dictionary optimal encoder
# ---------------------------------------------------------------------------


def encode_multi_opt(
    lookups16: List[LookupTable], lookups8: List[LookupTable], gaps: np.ndarray
) -> bytes:
    """Exhaustive per-chunk selector choice (multi_opt_dint :450-518)."""
    out = bytearray()
    n = int(gaps.shape[0])
    pos = 0
    while pos < n:
        size = min(BLOCK_SIZE, n - pos)
        chunk = gaps[pos : pos + size]
        best: Optional[bytes] = None
        best_sc = 0
        for s in range(NUM_SELECTORS):
            e16 = encode_opt_single(lookups16[s], chunk, 16)
            e8 = encode_opt_single(lookups8[s], chunk, 8)
            # reference tie-breaks: b=8 wins ties within a selector
            # (:478-483); across selectors strictly smaller wins (:485-489)
            if len(e8) <= len(e16):
                cand, sc = e8, s + NUM_SELECTORS
            else:
                cand, sc = e16, s
            if best is None or len(cand) < len(best):
                best, best_sc = cand, sc
        out.append(best_sc)
        out += best
        pos += size
    return bytes(out)
