"""Binary interpolative coding, level-ordered (host copy).

The port's own copy of ``dint_tpu/codecs/interpolative.py``: it codes
the partial (< 256) blocks of a DINT index, and a test holds it equal to
the reference package's.

The reference (interpolative_coding.hpp:40-70,109-146; block_codecs.hpp
``interpolative_block``) codes the midpoint of a prefix-sum array with a
centered minimal binary code, then recurses left/right (DFS order).  The
DFS bit layout forces a sequential bit-walk at decode time.

We emit EXACTLY the same minimal binary codes — so the encoded size in
bits is identical to the reference, preserving bpi parity — but order
them breadth-first, and within each tree level split the stream into a
fixed-width plane (the b-bit parts) followed by an extra-bit plane (the
conditional (b+1)-th bits).  All code widths at level d are computable
from values decoded at levels < d, so decoding is ceil(log2(n)) rounds
of fully-vectorized gathers + prefix sums — the TPU-native shape.

Minimal binary code of x in [0, u): b = floor(log2(u)), m = 2^(b+1) - u.
x < m  -> b bits holding x.
x >= m -> b+1 bits holding x+m (split: high b bits in the fixed plane,
          low bit in the extra plane).  Decode: v = b fixed bits; if
          v >= m then v = 2v + extra - m.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from . import vbyte

UNKNOWN_SUM = 0xFFFFFFFF


class BitWriter:
    """Little-endian bit accumulator (bit k of the stream = bit k%8 of byte k//8)."""

    def __init__(self):
        self.acc = 0
        self.nbits = 0

    def write(self, bits: int, length: int) -> None:
        if length == 0:
            return
        assert 0 <= bits < (1 << length)
        self.acc |= bits << self.nbits
        self.nbits += length

    def to_bytes(self) -> bytes:
        nbytes = (self.nbits + 7) // 8
        return self.acc.to_bytes(nbytes, "little") if nbytes else b""


class BitReader:
    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.base = pos
        self.bitpos = 0

    def read(self, length: int) -> int:
        if length == 0:
            return 0
        start = self.bitpos
        self.bitpos += length
        first = self.base + start // 8
        last = self.base + (start + length - 1) // 8
        word = int.from_bytes(bytes(self.buf[first : last + 1]), "little")
        return (word >> (start % 8)) & ((1 << length) - 1)

    def bytes_consumed(self) -> int:
        return (self.bitpos + 7) // 8


def _floor_log2(u: int) -> int:
    return u.bit_length() - 1


def level_nodes(n: int) -> List[List[Tuple[int, int]]]:
    """BFS levels of (start, end) half-open subranges for an n-value tree.

    Purely structural: depends on n only.  Node (s, e) codes index
    s + (e-s)//2 and spawns children (s, mid) and (mid+1, e).
    """
    levels: List[List[Tuple[int, int]]] = []
    cur = [(0, n)] if n > 0 else []
    while cur:
        levels.append(cur)
        nxt: List[Tuple[int, int]] = []
        for s, e in cur:
            h = (e - s) // 2
            mid = s + h
            if mid - s > 0:
                nxt.append((s, mid))
            if e - (mid + 1) > 0:
                nxt.append((mid + 1, e))
        cur = nxt
    return levels


def encode_prefix_sums(vals: np.ndarray, low0: int, high0: int) -> bytes:
    """Encode the n strictly-nondecreasing values with bounds [low0, high0]."""
    n = int(vals.shape[0])
    if n == 0:
        return b""
    vals = np.asarray(vals, dtype=np.int64)
    bw = BitWriter()
    # Per-node decode bounds, computed alongside the traversal.
    lows = {(0, n): low0}
    highs = {(0, n): high0}
    for level in level_nodes(n):
        fixed = BitWriter()
        extra = BitWriter()
        for s, e in level:
            h = (e - s) // 2
            mid = s + h
            low, high = lows[(s, e)], highs[(s, e)]
            val = int(vals[mid])
            assert low <= val <= high, (low, val, high)
            u = high - low + 1
            x = val - low
            b = _floor_log2(u)
            m = (1 << (b + 1)) - u
            if x < m:
                fixed.write(x, b)
            else:
                y = x + m
                fixed.write(y >> 1, b)
                extra.write(y & 1, 1)
            if mid - s > 0:
                lows[(s, mid)] = low
                highs[(s, mid)] = val
            if e - (mid + 1) > 0:
                lows[(mid + 1, e)] = val
                highs[(mid + 1, e)] = high
        bw.write(fixed.acc, fixed.nbits)
        bw.write(extra.acc, extra.nbits)
    return bw.to_bytes()


def _decode_prefix_sums_level(buf, pos: int, n: int, low0: int, high0: int):
    """Level-vectorized single-block decode — measured SLOWER than the
    scalar walk for lone blocks (numpy per-op overhead on <=128-node
    levels); kept as the stepping stone to the cross-block batch below,
    which is where vectorization pays."""
    if n == 0:
        return np.zeros(0, dtype=np.int64), 0
    out = np.zeros(n, dtype=np.int64)
    # Each code is <= 33 bits (u <= 2^32), so n codes span <= 33n bits;
    # slice just that much (the buffer may be a whole index arena).
    # 8 bytes starting at each code's first byte cover any b <= 57 bits.
    ub = min(len(buf) - pos, (33 * n + 7) // 8 + 8)
    arr = np.frombuffer(bytes(buf[pos : pos + ub]), np.uint8)
    bitpos = 0
    # level state: node arrays (s, e, low, high)
    s = np.array([0], np.int64)
    e = np.array([n], np.int64)
    low = np.array([low0], np.int64)
    high = np.array([high0], np.int64)
    pad = np.zeros(8, np.uint8)
    ab = np.concatenate([arr, pad])
    while s.size:
        mid = s + (e - s) // 2
        u = high - low + 1
        # floor_log2 via frexp (exact for u < 2^53): bit_length(u) - 1
        b = np.frexp(u.astype(np.float64))[1].astype(np.int64) - 1
        m = (np.int64(1) << (b + 1)) - u
        # fixed-plane reads: widths b at offsets bitpos + cumsum
        offs = bitpos + np.concatenate([[0], np.cumsum(b)[:-1]])
        first = (offs >> 3).astype(np.int64)
        words = np.zeros(s.size, np.uint64)
        for k in range(8):
            words |= ab[first + k].astype(np.uint64) << np.uint64(8 * k)
        v = ((words >> (offs & 7).astype(np.uint64))
             & ((np.uint64(1) << b.astype(np.uint64)) - np.uint64(1))
             ).astype(np.int64)
        bitpos += int(b.sum())
        # extra-plane: one bit for each v >= m, in node order
        need = v >= m
        cnt = int(need.sum())
        if cnt:
            eoffs = bitpos + np.arange(cnt, dtype=np.int64)
            bits = (ab[eoffs >> 3] >> (eoffs & 7).astype(np.uint8)) & 1
            extra = np.zeros(s.size, np.int64)
            extra[need] = bits
            v = np.where(need, (v << 1) + extra - m, v)
            bitpos += cnt
        val = low + v
        out[mid] = val
        # children: (s, mid, low, val) and (mid+1, e, val, high)
        lmask = mid - s > 0
        rmask = e - (mid + 1) > 0
        # interleave in the exact order level_nodes produces: for each
        # node, left child (if any) then right child (if any)
        ns_ = np.empty(int(lmask.sum()) + int(rmask.sum()), np.int64)
        ne_ = np.empty_like(ns_)
        nlow = np.empty_like(ns_)
        nhigh = np.empty_like(ns_)
        idx = np.cumsum(lmask.astype(np.int64) + rmask.astype(np.int64))
        base = idx - (lmask.astype(np.int64) + rmask.astype(np.int64))
        lpos = base[lmask]
        ns_[lpos] = s[lmask]
        ne_[lpos] = mid[lmask]
        nlow[lpos] = low[lmask]
        nhigh[lpos] = val[lmask]
        rpos = (base + lmask.astype(np.int64))[rmask]
        ns_[rpos] = mid[rmask] + 1
        ne_[rpos] = e[rmask]
        nlow[rpos] = val[rmask]
        nhigh[rpos] = high[rmask]
        s, e, low, high = ns_, ne_, nlow, nhigh
    return out, (bitpos + 7) // 8


def decode_prefix_sums(buf, pos: int, n: int, low0: int, high0: int):
    """Inverse of encode_prefix_sums; returns (values, bytes_consumed)."""
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out, 0
    br = BitReader(buf, pos)
    lows = {(0, n): low0}
    highs = {(0, n): high0}
    for level in level_nodes(n):
        meta = []
        for s, e in level:
            h = (e - s) // 2
            mid = s + h
            low, high = lows[(s, e)], highs[(s, e)]
            u = high - low + 1
            b = _floor_log2(u)
            m = (1 << (b + 1)) - u
            meta.append((s, e, mid, low, high, b, m))
        partial = []
        for s, e, mid, low, high, b, m in meta:
            partial.append(br.read(b))
        for (s, e, mid, low, high, b, m), v in zip(meta, partial):
            if v >= m:
                v = (v << 1) + br.read(1) - m
            val = low + v
            out[mid] = val
            if mid - s > 0:
                lows[(s, mid)] = low
                highs[(s, mid)] = val
            if e - (mid + 1) > 0:
                lows[(mid + 1, e)] = val
                highs[(mid + 1, e)] = high
    return out, br.bytes_consumed()


def encoded_bits(vals: np.ndarray, low0: int, high0: int) -> int:
    """Exact bit count (same as the reference DFS coder would produce)."""
    n = int(vals.shape[0])
    total = 0
    if n == 0:
        return 0
    vals = np.asarray(vals, dtype=np.int64)
    stack = [(0, n, low0, high0)]
    while stack:
        s, e, low, high = stack.pop()
        h = (e - s) // 2
        mid = s + h
        val = int(vals[mid])
        u = high - low + 1
        b = _floor_log2(u)
        m = (1 << (b + 1)) - u
        total += b + (0 if (val - low) < m else 1)
        if mid - s > 0:
            stack.append((s, mid, low, val))
        if e - (mid + 1) > 0:
            stack.append((mid + 1, e, val, high))
    return total


def encode_block(values: np.ndarray, sum_of_values: int) -> bytes:
    """interpolative_block::encode semantics (block_codecs.hpp:104-129).

    ``values`` are the raw (gap) values of a partial block; they are
    prefix-summed, the final sum is implied by ``sum_of_values`` (or
    vbyte-prefixed when unknown), and the first n-1 prefix sums are
    interpolative-coded in [0, sum].
    """
    values = np.asarray(values, dtype=np.int64)
    n = int(values.shape[0])
    assert 0 < n <= BLOCK_SIZE
    psums = np.cumsum(values)
    out = bytearray()
    if sum_of_values == UNKNOWN_SUM:
        sum_of_values = int(psums[-1])
        if sum_of_values >= UNKNOWN_SUM:
            # the reference stores the sum as a u32 vbyte
            # (block_codecs.hpp interpolative_block) — same contract
            # here, but fail loudly instead of silently truncating
            raise ValueError(
                f"interpolative block sum {sum_of_values} exceeds u32"
            )
        out += vbyte.encode_single(sum_of_values)
    out += encode_prefix_sums(psums[: n - 1], 0, int(sum_of_values))
    return bytes(out)


def decode_block(buf, pos: int, n: int, sum_of_values: int):
    """Returns (values, new_pos)."""
    start = pos
    if sum_of_values == UNKNOWN_SUM:
        sum_of_values, pos = vbyte.decode_single(buf, pos)
    psums, consumed = decode_prefix_sums(buf, pos, n - 1, 0, int(sum_of_values))
    pos += consumed
    full = np.empty(n, dtype=np.int64)
    full[: n - 1] = psums
    full[n - 1] = sum_of_values
    vals = np.empty(n, dtype=np.int64)
    vals[0] = full[0]
    vals[1:] = full[1:] - full[:-1]
    return vals.astype(np.uint32), pos


def decode_blocks_batch(buf, specs):
    """Decode MANY interpolative blocks at once; returns a list of value
    arrays.  ``specs`` is a sequence of (pos, n, sum_of_values) (with
    UNKNOWN_SUM handled per block).

    This is where the level-ordered layout pays: all blocks' level-d
    nodes process as one numpy batch (bit extraction, bound updates,
    child expansion), so the per-level numpy overhead amortizes across
    blocks — the single-block scalar walk stays faster for lone blocks.
    """
    B = len(specs)
    if B == 0:
        return []
    buf = np.asarray(buf, dtype=np.uint8)
    poss = np.empty(B, np.int64)
    ns = np.empty(B, np.int64)
    sums = np.empty(B, np.int64)
    for i, (pos, n, sv) in enumerate(specs):
        if sv == UNKNOWN_SUM:
            sv, pos = vbyte.decode_single(buf, pos)
        poss[i] = pos
        ns[i] = n
        sums[i] = sv
    # consolidated bit arena: slice each block's max span into one pad-
    # safe buffer so byte gathers never index past the end
    spans = (33 * np.maximum(ns - 1, 0) + 7) // 8 + 8
    spans = np.minimum(spans, len(buf) - poss)
    starts = np.concatenate([[0], np.cumsum(spans)[:-1]])
    ab = np.zeros(int(spans.sum()) + 8, np.uint8)
    for i in range(B):
        ab[starts[i] : starts[i] + spans[i]] = buf[poss[i] : poss[i] + spans[i]]

    out_off = np.concatenate([[0], np.cumsum(ns)[:-1]])
    out_flat = np.zeros(int(ns.sum()), np.int64)
    blk_bit = np.zeros(B, np.int64)  # per-block bit cursor

    # live node state (grouped by block, block-major order)
    m_root = ns - 1 > 0
    bid = np.flatnonzero(m_root)
    s = np.zeros(bid.size, np.int64)
    e = (ns - 1)[bid]
    low = np.zeros(bid.size, np.int64)
    high = sums[bid]

    while bid.size:
        mid = s + (e - s) // 2
        u = high - low + 1
        b = np.frexp(u.astype(np.float64))[1].astype(np.int64) - 1
        m = (np.int64(1) << (b + 1)) - u
        # per-block exclusive cumsum of widths (nodes are block-grouped)
        csum = np.cumsum(b)
        excl = csum - b
        seg_first = np.concatenate([[True], bid[1:] != bid[:-1]])
        seg_idx = np.cumsum(seg_first) - 1
        seg_base = excl[seg_first][seg_idx]
        offs = blk_bit[bid] + starts[bid] * 8 + (excl - seg_base)
        first = offs >> 3
        words = np.zeros(bid.size, np.uint64)
        for k in range(8):
            words |= ab[first + k].astype(np.uint64) << np.uint64(8 * k)
        v = (
            (words >> (offs & 7).astype(np.uint64))
            & ((np.uint64(1) << b.astype(np.uint64)) - np.uint64(1))
        ).astype(np.int64)
        # advance per-block cursors by each block's fixed-plane total
        seg_start_ids = bid[seg_first]
        seg_last = np.concatenate([seg_first[1:], [True]])
        fixed_tot = csum[seg_last] - np.concatenate([[0], csum[seg_last][:-1]])
        np.add.at(blk_bit, seg_start_ids, fixed_tot)
        # extra-plane bits: rank among needy nodes of the same block
        need = v >= m
        nb = need.astype(np.int64)
        ncsum = np.cumsum(nb)
        nexcl = ncsum - nb
        nbase = nexcl[seg_first][seg_idx]
        eoffs = blk_bit[bid] + starts[bid] * 8 + (nexcl - nbase)
        bits = (ab[eoffs >> 3] >> (eoffs & 7).astype(np.uint8)) & 1
        v = np.where(need, (v << 1) + bits.astype(np.int64) - m, v)
        ntot = ncsum[seg_last] - np.concatenate([[0], ncsum[seg_last][:-1]])
        np.add.at(blk_bit, seg_start_ids, ntot)
        val = low + v
        out_flat[out_off[bid] + mid] = val
        # children
        lmask = mid - s > 0
        rmask = e - (mid + 1) > 0
        cnt = lmask.astype(np.int64) + rmask.astype(np.int64)
        base = np.cumsum(cnt) - cnt
        tot = int(cnt.sum())
        nbid = np.empty(tot, np.int64)
        ns_ = np.empty(tot, np.int64)
        ne_ = np.empty(tot, np.int64)
        nlow = np.empty(tot, np.int64)
        nhigh = np.empty(tot, np.int64)
        lpos = base[lmask]
        nbid[lpos] = bid[lmask]
        ns_[lpos] = s[lmask]
        ne_[lpos] = mid[lmask]
        nlow[lpos] = low[lmask]
        nhigh[lpos] = val[lmask]
        rpos = (base + lmask.astype(np.int64))[rmask]
        nbid[rpos] = bid[rmask]
        ns_[rpos] = mid[rmask] + 1
        ne_[rpos] = e[rmask]
        nlow[rpos] = val[rmask]
        nhigh[rpos] = high[rmask]
        bid, s, e, low, high = nbid, ns_, ne_, nlow, nhigh

    # rebuild gap values from prefix sums: set each block's final
    # prefix sum, then adjacent differences within block boundaries
    out_flat[out_off + ns - 1] = sums
    diffs = np.empty_like(out_flat)
    diffs[0] = out_flat[0]
    diffs[1:] = out_flat[1:] - out_flat[:-1]
    diffs[out_off] = out_flat[out_off]  # block firsts keep raw value
    res = [
        diffs[out_off[i] : out_off[i] + int(ns[i])].astype(np.uint32)
        for i in range(B)
    ]
    return res
