"""Skipping enumerators for the Elias-Fano sequence family (host copy).

The reference's sequences are consumed through pointer-walking
enumerators with `move(k)` / `next()` / `next_geq(lb)` fast paths that
use the sampled 1-/0-pointer directories (compact_elias_fano.hpp
:138-417, compact_ranked_bitvector.hpp enumerators).  The rebuild's
batch readers (`decode_all`) cover the scan-everything access pattern;
these enumerators add the SKIPPING access pattern — the EF-family
analogue of the DINT index's block_max jumps — using the same sampled
pointers the writers emit (byte-exact with the reference layout).

Positions/values follow the reference convention: an exhausted
enumerator reports position == n and value == universe.

All scans are bounded by the sampling windows (<= 2^log_sampling bits
between samples), done word-at-a-time with popcounts.
"""

from __future__ import annotations

import numpy as np

from ..utils import bitio
from . import ef as ef_mod


def _popcount(x: int) -> int:
    return int(x).bit_count()


class _HighBits:
    """Word-scan helpers over a bit region [start, start+length)."""

    def __init__(self, words: np.ndarray, start: int, length: int):
        self.words = words
        self.start = start
        self.length = length

    def _word(self, i: int) -> int:
        return int(self.words[i]) if i < self.words.shape[0] else 0

    def select1_from(self, rel: int, k: int) -> int:
        """Relative position of the k-th one (0-based among ones at
        relative positions >= rel); -1 if none."""
        rel, k = int(rel), int(k)
        a = self.start + rel
        end = self.start + self.length
        wi = a >> 6
        w = self._word(wi) >> (a & 63)
        base = a
        need = k
        while base < end:
            c = _popcount(w)
            if c > need:
                # locate the need-th set bit in w
                while need:
                    w &= w - 1
                    need -= 1
                off = (w & -w).bit_length() - 1
                p = base + off
                return p - self.start if p < end else -1
            need -= c
            wi += 1
            base = (wi << 6)
            w = self._word(wi)
        return -1

    def pred1(self, rel: int) -> int:
        """Relative position of the last one at relative position <= rel
        (bit_vector::predecessor1 semantics); -1 if none."""
        rel = int(rel)
        if rel < 0:
            return -1
        if rel >= self.length:
            rel = self.length - 1
        a = self.start + rel
        wi = a >> 6
        keep = (a & 63) + 1
        w = self._word(wi) & ((1 << keep) - 1)
        while True:
            if w:
                p = (wi << 6) + w.bit_length() - 1
                return p - self.start if p >= self.start else -1
            if wi == self.start >> 6:
                return -1
            wi -= 1
            w = self._word(wi)

    def select0_from(self, rel: int, k: int) -> int:
        """Relative position of the k-th zero (0-based among zeros at
        relative positions >= rel); -1 if none in the region."""
        rel, k = int(rel), int(k)
        a = self.start + rel
        end = self.start + self.length
        wi = a >> 6
        w = (~self._word(wi)) & ((1 << 64) - 1)
        w >>= a & 63
        base = a
        need = k
        while base < end:
            # mask off bits beyond the region end in the last word
            avail = min(64 - (base & 63) if base & 63 else 64, end - base)
            ww = w & ((1 << avail) - 1)
            c = _popcount(ww)
            if c > need:
                while need:
                    ww &= ww - 1
                    need -= 1
                return base + ((ww & -ww).bit_length() - 1) - self.start
            need -= c
            wi += 1
            base = wi << 6
            w = (~self._word(wi)) & ((1 << 64) - 1)
        return -1


class EFEnumerator:
    """compact_elias_fano enumerator (move/next/next_geq)."""

    def __init__(self, words, offset: int, universe: int, n: int, p=None):
        p = p or ef_mod.PARAMS
        self.of = ef_mod.ef_offsets(offset, universe, n, p)
        self.words = words
        self.universe = universe
        self.n = n
        self.p = p
        of = self.of
        self.hb = _HighBits(words, of.higher_bits_offset, of.higher_bits_length)
        self._pos = -1
        self._q = -1  # relative one position of current element
        self._value = universe

    # ---- raw reads ----
    def _low(self, k: int) -> int:
        of = self.of
        if not of.lower_bits:
            return 0
        return bitio.read_bits_scalar(
            self.words, of.lower_bits_offset + k * of.lower_bits, of.lower_bits
        )

    def _ptr1(self, i: int) -> int:
        """High position of element i << log_sampling1 (slot i-1)."""
        of = self.of
        return bitio.read_bits_scalar(
            self.words, of.pointers1_offset + (i - 1) * of.pointer_size,
            of.pointer_size,
        )

    def _ptr0(self, j: int) -> int:
        """Position of the zero with (j << log_sampling0) zeros before
        it (slot j-1; compact_elias_fano.hpp set_ptr0s)."""
        of = self.of
        return bitio.read_bits_scalar(
            self.words, of.pointers0_offset + (j - 1) * of.pointer_size,
            of.pointer_size,
        )

    def _exhaust(self):
        self._pos = self.n
        self._q = -1
        self._value = self.universe
        return self._value

    def _locate(self, k: int) -> int:
        """Relative high position of the k-th one via the 1-pointer
        directory; no enumerator state is touched."""
        log1 = self.of.log_sampling1
        si = k >> log1
        if si > 0:
            return self.hb.select1_from(self._ptr1(si), k - (si << log1))
        return self.hb.select1_from(0, k)

    def _set(self, pos: int, q: int):
        self._pos = pos
        self._q = q
        high = q - pos - 1
        self._value = (high << self.of.lower_bits) | self._low(pos)
        return self._value

    # ---- API ----
    def position(self) -> int:
        return self._pos

    def value(self) -> int:
        return self._value

    def size(self) -> int:
        return self.n

    def move(self, k: int) -> int:
        """Position to element k; returns its value."""
        if k >= self.n:
            return self._exhaust()
        if self._pos >= 0 and k == self._pos:
            return self._value
        log1 = self.of.log_sampling1
        start_rel = 0
        base = 0
        if self._pos >= 0 and self._pos <= k and (k >> log1) == (
            self._pos >> log1
        ):
            start_rel = self._q  # forward from current position
            base = self._pos
            q = self.hb.select1_from(start_rel, k - base)
        else:
            si = k >> log1
            if si > 0:
                start_rel = self._ptr1(si)
                base = si << log1
                q = self.hb.select1_from(start_rel, k - base)
            else:
                q = self.hb.select1_from(0, k)
        if q < 0:
            return self._exhaust()
        return self._set(k, q)

    def next(self) -> int:
        k = self._pos + 1
        if k >= self.n:
            return self._exhaust()
        if self._q >= 0:
            q = self.hb.select1_from(self._q + 1, 0)
            if q < 0:
                return self._exhaust()
            return self._set(k, q)
        return self.move(k)

    def prev_value(self) -> int:
        """Value of the element before the current position — 0 at
        position 0, the last element once exhausted
        (compact_elias_fano.hpp:234-254)."""
        if self._pos <= 0:
            return 0
        if self._pos < self.n and self._q >= 0:
            prev_high = self.hb.pred1(self._q - 1)
        else:
            prev_high = self.hb.pred1(self.of.higher_bits_length - 1)
        prev_pos = self._pos - 1
        return ((prev_high - prev_pos - 1) << self.of.lower_bits) | self._low(
            prev_pos
        )

    def next_reader(self, position: int) -> "EFNextReader":
        """Streaming reader yielding elements position, position+1, ...
        without disturbing this enumerator (the moral equivalent of the
        reference's next_reader, compact_elias_fano.hpp:359-388 — there
        it commits the high cursor back on destruction; here the
        enumerator state is simply left untouched)."""
        return EFNextReader(self, position)

    def next_geq(self, lb: int) -> int:
        """First element >= lb (queries.hpp leapfrog contract)."""
        if lb > self.universe:
            return self._exhaust()
        if self._pos >= 0 and self._value >= lb and self._pos < self.n:
            return self._value
        of = self.of
        h = lb >> of.lower_bits
        total_zeros = of.higher_bits_length - self.n
        log0 = of.log_sampling0
        if h == 0:
            i0 = 0
            q = self.hb.select1_from(0, 0)
        else:
            if h > total_zeros:
                return self._exhaust()
            # Z(h) = the zero with exactly h zeros before it (rank h):
            # jump via the 0-pointer directory, then a bounded zero scan
            sj = h >> log0
            if sj > 0:
                zstart = self._ptr0(sj)  # zero with (sj<<log0) before it
                z = self.hb.select0_from(zstart, h - (sj << log0))
            else:
                z = self.hb.select0_from(0, h)
            if z < 0:
                return self._exhaust()
            i0 = z - h  # ones before Z(h)
            if i0 >= self.n:
                return self._exhaust()
            q = self.hb.select1_from(z + 1, 0)
        if q < 0:
            return self._exhaust()
        pos = i0
        lo_target = lb & ((1 << of.lower_bits) - 1) if of.lower_bits else 0
        while True:
            high = q - pos - 1
            if high > h:
                return self._set(pos, q)
            lo = self._low(pos)
            if lo >= lo_target:
                return self._set(pos, q)
            pos += 1
            if pos >= self.n:
                return self._exhaust()
            q = self.hb.select1_from(q + 1, 0)
            if q < 0:
                return self._exhaust()


class EFNextReader:
    """Streaming forward reader over an EFEnumerator's sequence from a
    given position: each call returns the next value.  One select per
    call over the high bits plus a sequential low-bits cursor — the
    reference's next_reader loop shape (compact_elias_fano.hpp:359-388).
    The owning enumerator's state is never modified."""

    def __init__(self, e: "EFEnumerator", position: int):
        self.e = e
        self.pos = position
        of = e.of
        self.lower_bits = of.lower_bits
        self.low_cursor = of.lower_bits_offset + position * of.lower_bits
        self._q = e._locate(position) if 0 <= position < e.n else -1

    def __call__(self) -> int:
        e = self.e
        if self.pos >= e.n or self._q < 0:
            return e.universe
        high = self._q - self.pos - 1
        lo = (
            bitio.read_bits_scalar(e.words, self.low_cursor, self.lower_bits)
            if self.lower_bits
            else 0
        )
        v = (high << self.lower_bits) | lo
        self.pos += 1
        self.low_cursor += self.lower_bits
        self._q = e.hb.select1_from(self._q + 1, 0) if self.pos < e.n else -1
        return v


class RBEnumerator:
    """compact_ranked_bitvector enumerator."""

    def __init__(self, words, offset: int, universe: int, n: int, p=None):
        p = p or ef_mod.PARAMS
        (self.r1size, self.psize, self.r1samples, self.ptrs1,
         self.r1off, self.p1off, self.bits_off, _end) = (
            ef_mod.compact_ranked_bitvector._offsets(offset, universe, n, p)
        )
        self.words = words
        self.universe = universe
        self.n = n
        self.p = p
        self.bits = _HighBits(words, self.bits_off, universe)
        self._pos = -1
        self._value = universe

    def position(self) -> int:
        return self._pos

    def value(self) -> int:
        return self._value

    def size(self) -> int:
        return self.n

    def _exhaust(self):
        self._pos = self.n
        self._value = self.universe
        return self._value

    def move(self, k: int) -> int:
        if k >= self.n:
            return self._exhaust()
        log1 = self.p.rb_log_sampling1
        if self._pos >= 0 and self._pos <= k and (k >> log1) == (
            self._pos >> log1
        ):
            v = self.bits.select1_from(self._value, k - self._pos)
        else:
            si = k >> log1
            if si > 0:
                sample_v = bitio.read_bits_scalar(
                    self.words, self.p1off + (si - 1) * self.psize, self.psize
                )
                v = self.bits.select1_from(sample_v, k - (si << log1))
            else:
                v = self.bits.select1_from(0, k)
        if v < 0:
            return self._exhaust()
        self._pos = k
        self._value = v
        return v

    def next(self) -> int:
        k = self._pos + 1
        if k >= self.n:
            return self._exhaust()
        v = self.bits.select1_from(self._value + 1, 0)
        if v < 0:
            return self._exhaust()
        self._pos = k
        self._value = v
        return v

    def next_geq(self, lb: int) -> int:
        if lb >= self.universe:
            return self._exhaust()
        if self._pos >= 0 and self._value >= lb and self._pos < self.n:
            return self._value
        logr = self.p.rb_log_rank1_sampling
        sj = lb >> logr
        if sj > 0:
            rank = bitio.read_bits_scalar(
                self.words, self.r1off + (sj - 1) * self.r1size, self.r1size
            )
            start = sj << logr
        else:
            rank = 0
            start = 0
        # count ones in [start, lb), then take the first one >= lb
        pos = rank
        v = self.bits.select1_from(start, 0)
        while 0 <= v < lb:
            pos += 1
            v = self.bits.select1_from(v + 1, 0)
        if v < 0 or pos >= self.n:
            return self._exhaust()
        self._pos = pos
        self._value = v
        return v

    def prev_value(self) -> int:
        """compact_ranked_bitvector.hpp:208-222 semantics."""
        if self._pos <= 0:
            return 0
        if self._pos < self.n:
            return self.bits.pred1(self._value - 1)
        return self.bits.pred1(self.universe - 1)


class AllOnesEnumerator:
    def __init__(self, words, offset, universe, n, p=None):
        assert universe == n
        self.universe = universe
        self.n = n
        self._pos = -1

    def position(self):
        return self._pos

    def value(self):
        return self._pos if 0 <= self._pos < self.n else self.universe

    def size(self):
        return self.n

    def move(self, k):
        self._pos = min(k, self.n)
        return self.value()

    def next(self):
        return self.move(self._pos + 1)

    def next_geq(self, lb):
        if 0 <= self._pos < self.n and self._pos >= lb:
            return self._pos
        return self.move(max(lb, 0))

    def prev_value(self):
        """all_ones_sequence.hpp:64-70 semantics."""
        return self._pos - 1 if self._pos > 0 else 0


def indexed_enumerator(words, offset: int, universe: int, n: int, p=None):
    """Dispatching enumerator for indexed_sequence (1-bit type tag,
    all_ones implicit when universe == n)."""
    p = p or ef_mod.PARAMS
    if ef_mod.all_ones_sequence.bitsize(p, universe, n) == 0:
        return AllOnesEnumerator(words, offset, universe, n, p)
    t = bitio.read_bits_scalar(words, offset, ef_mod.indexed_sequence.TYPE_BITS)
    off = offset + ef_mod.indexed_sequence.TYPE_BITS
    if t == 0:
        return EFEnumerator(words, off, universe, n, p)
    return RBEnumerator(words, off, universe, n, p)


class StrictEFEnumerator:
    """strict_elias_fano: compact EF over universe-n+1 with
    value = inner + index (untagged; standard sampling params —
    strict_elias_fano.write passes p through)."""

    def __init__(self, words, offset: int, universe: int, n: int, p=None):
        self.n = n
        self.universe = universe
        self.inner = EFEnumerator(words, offset, universe - n + 1, n, p)

    def move(self, k: int) -> int:
        v = self.inner.move(k)
        if k >= self.n:
            return self.universe
        return v + k

    def position(self) -> int:
        return self.inner.position()

    def next(self) -> int:
        return self.move(self.inner.position() + 1)

    def prev_value(self) -> int:
        """strict_elias_fano.hpp:69-76 semantics."""
        pos = self.inner.position()
        if pos <= 0:
            return 0
        return self.inner.prev_value() + pos - 1


class StrictSeqEnumerator:
    """strict_sequence: 1-bit tag among {strict EF, ranked bitvector,
    all-ones}, zero-sampling disabled (_strict_params) — move-only
    access (freqs are read by position)."""

    def __init__(self, words, offset: int, universe: int, n: int, p=None):
        p = p or ef_mod.PARAMS
        sp = ef_mod._strict_params(p)
        self.n = n
        self.universe = universe
        if ef_mod.all_ones_sequence.bitsize(p, universe, n) == 0:
            self.inner = AllOnesEnumerator(words, offset, universe, n, sp)
            self.shift = False
            return
        t = bitio.read_bits_scalar(
            words, offset, ef_mod.strict_sequence.TYPE_BITS
        )
        off = offset + ef_mod.strict_sequence.TYPE_BITS
        if t == 0:
            self.inner = EFEnumerator(words, off, universe - n + 1, n, sp)
            self.shift = True
        else:
            self.inner = RBEnumerator(words, off, universe, n, sp)
            self.shift = False

    def move(self, k: int) -> int:
        v = self.inner.move(k)
        if k >= self.n:
            return self.universe
        return v + k if self.shift else v

    def position(self) -> int:
        return self.inner.position()

    def next(self) -> int:
        return self.move(self.inner.position() + 1)

    def prev_value(self) -> int:
        """strict_sequence enumerators delegate; the strict-EF arm adds
        back the +index shift (strict_elias_fano.hpp:69-76)."""
        pos = self.inner.position()
        if pos <= 0:
            return 0
        if self.shift:
            return self.inner.prev_value() + pos - 1
        return self.inner.prev_value()


# backwards-compatible alias (tests use the tagged variant)
StrictEnumerator = StrictSeqEnumerator


class PartitionedEnumerator:
    """partitioned_sequence / uniform_partitioned_sequence enumerator
    (partitioned_sequence.hpp:240-345 semantics): the partition
    directory (sizes, upper bounds, endpoints) decodes eagerly at
    construction — it is tiny — and per-partition base enumerators
    open lazily on first touch; ``next_geq`` picks the partition by
    binary search over the upper-bounds directory (:276-297), the
    skip structure PEF exists for."""

    def __init__(self, words, offset: int, universe: int, n: int, p=None,
                 base: str = "indexed", uniform: bool = False):
        p = p or ef_mod.PARAMS
        self.words = words
        self.universe = universe
        self.n = n
        self.p = p
        self.base_kind = base
        r = bitio.BitReader(words, offset)
        partitions = ef_mod.read_gamma(r) + 1
        self.partitions = partitions
        self._enum = {}
        self._pos = -1
        self._value = universe
        self._cur_part = -1
        if partitions == 1:
            cur_base = r.take(bitio.ceil_log2(universe))
            if n > 1:
                ub = ef_mod.read_delta(r)
                part_universe = (universe - cur_base) if ub == 0 else ub + 1
            else:
                part_universe = 1
            self.part_starts = [0, n]
            self.bases = [cur_base]
            self.rel_universes = [part_universe]
            self.seq_offsets = [r.pos]
            self.part_maxes = [universe - 1]  # unused for 1 partition
            return
        endpoint_bits = ef_mod.read_gamma(r)
        pos = r.pos
        if not uniform:
            so = ef_mod.ef_offsets(pos, n, partitions - 1, p)
            sizes = ef_mod.compact_elias_fano.decode_all(
                words, pos, n, partitions - 1, p
            )
            pos = so.end
            partition = list(sizes.astype(np.int64)) + [n]
        else:
            ps = 1 << p.log_partition_size
            partition = list(range(ps, n, ps)) + [n]
        uo = ef_mod.ef_offsets(pos, universe, partitions + 1, p)
        ubs = ef_mod.compact_elias_fano.decode_all(
            words, pos, universe, partitions + 1, p
        ).astype(np.int64)
        pos = uo.end
        endpoints = [0]
        for k in range(partitions - 1):
            endpoints.append(bitio.read_bits_scalar(words, pos, endpoint_bits))
            pos += endpoint_bits
        seq_base = pos
        self.part_starts = [0] + [int(x) for x in partition]
        self.bases = []
        self.rel_universes = []
        self.seq_offsets = [int(seq_base) + int(e) for e in endpoints]
        self.part_maxes = [int(x) for x in ubs[1:]]
        cur_base = int(ubs[0])
        for k in range(partitions):
            ub = int(ubs[k + 1])
            self.bases.append(cur_base)
            self.rel_universes.append(ub - cur_base + 1)
            cur_base = ub + 1

    def _open(self, k: int):
        e = self._enum.get(k)
        if e is None:
            m = self.part_starts[k + 1] - self.part_starts[k]
            if self.base_kind == "indexed":
                e = indexed_enumerator(
                    self.words, self.seq_offsets[k], self.rel_universes[k],
                    m, self.p,
                )
            else:  # strict (freqs)
                e = StrictSeqEnumerator(
                    self.words, self.seq_offsets[k], self.rel_universes[k],
                    m, self.p,
                )
            self._enum[k] = e
        return e

    def position(self) -> int:
        return self._pos

    def value(self) -> int:
        return self._value

    def size(self) -> int:
        return self.n

    def _exhaust(self):
        self._pos = self.n
        self._value = self.universe
        return self._value

    def _part_of_pos(self, k_pos: int) -> int:
        import bisect

        return bisect.bisect_right(self.part_starts, k_pos) - 1

    def move(self, k_pos: int) -> int:
        if k_pos >= self.n:
            return self._exhaust()
        k = self._part_of_pos(k_pos)
        e = self._open(k)
        v = e.move(k_pos - self.part_starts[k])
        self._pos = k_pos
        self._cur_part = k
        self._value = v + self.bases[k]
        return self._value

    def next(self) -> int:
        return self.move(self._pos + 1)

    def prev_value(self) -> int:
        """partitioned_sequence.hpp:224-231: at a partition's first
        element the previous value is the previous partition's upper
        bound (cur_base - 1), 0 at the sequence head; otherwise the
        base enumerator's prev_value shifted by the partition base."""
        if self._pos <= 0:
            return 0
        if self._pos >= self.n:
            k = self.partitions - 1
            e = self._open(k)
            m = self.part_starts[k + 1] - self.part_starts[k]
            if e.position() < m:
                e.move(m)  # exhaust so prev_value reports its last element
        else:
            k = self._cur_part
            e = self._open(k)
        if self._pos == self.part_starts[k]:
            return self.bases[k] - 1 if k else 0
        return self.bases[k] + e.prev_value()

    def next_geq(self, lb: int) -> int:
        if 0 <= self._pos < self.n and self._value >= lb:
            return self._value
        if self.partitions == 1:
            k = 0
        else:
            import bisect

            k = bisect.bisect_left(self.part_maxes, lb)
            if k >= self.partitions:
                return self._exhaust()
        e = self._open(k)
        rel = max(lb - self.bases[k], 0)
        v = e.next_geq(rel)
        if (
            hasattr(e, "position") and e.position() >= (
                self.part_starts[k + 1] - self.part_starts[k]
            )
        ):
            # base exhausted (only possible in the single-partition case
            # or when lb exceeds every value)
            k += 1
            if k >= self.partitions:
                return self._exhaust()
            e = self._open(k)
            v = e.next_geq(0)
        self._cur_part = k
        self._pos = self.part_starts[k] + e.position()
        self._value = v + self.bases[k]
        return self._value
