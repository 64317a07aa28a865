"""Elias-Fano sequence family (host copy of ``dint_tpu/codecs/ef.py``).

Bit-layout-exact rebuild of the reference's sequences
(compact_elias_fano.hpp:14-136, compact_ranked_bitvector.hpp:14-115,
all_ones_sequence.hpp, indexed_sequence.hpp:24-87, strict_sequence.hpp,
strict_elias_fano.hpp:12-36, positive_sequence.hpp:15-30,
partitioned_sequence.hpp:21-120, uniform_partitioned_sequence.hpp:
19-105, optimal_partition.hpp:69-121, integer_codes.hpp) so bitsize /
bpi parity is exact.  Encoding is numpy-vectorized (batched scatter of
high bits, strided field packing); decoding materializes whole
sequences (batched queries consume dense arrays, and successor
queries become searchsorted), instead of the reference's
pointer-walking enumerators (those are ``codecs/ef_enum.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..utils import bitio, bitnative
from ..utils.bitio import BitBuilder, BitReader, ceil_log2


@dataclass
class GlobalParameters:
    """global_parameters.hpp:5-31."""

    ef_log_sampling0: int = 9
    ef_log_sampling1: int = 8
    rb_log_rank1_sampling: int = 9
    rb_log_sampling1: int = 8
    log_partition_size: int = 7


@dataclass
class Configuration:
    """configuration.hpp:27-35 (DS2I_* environment overrides, read at
    import as the C++ reference reads them at start-up)."""

    eps1: float = float(os.environ.get("DS2I_EPS1", 0.03))
    eps2: float = float(os.environ.get("DS2I_EPS2", 0.3))
    fix_cost: int = int(os.environ.get("DS2I_FIXCOST", 64))
    log_partition_size: int = int(os.environ.get("DS2I_LOG_PART", 7))


PARAMS = GlobalParameters()
CONF = Configuration()


# ---------------------------------------------------------------------------
# γ / δ codes (integer_codes.hpp)
# ---------------------------------------------------------------------------


def write_gamma(bb: BitBuilder, n: int) -> None:
    nn = n + 1
    l = nn.bit_length() - 1
    bb.append_bits(1 << l, l + 1)
    bb.append_bits(nn ^ (1 << l), l)


def write_gamma_nonzero(bb: BitBuilder, n: int) -> None:
    assert n > 0
    write_gamma(bb, n - 1)


def read_gamma(r: BitReader) -> int:
    l = r.skip_zeros()
    return (r.take(l) | (1 << l)) - 1


def write_delta(bb: BitBuilder, n: int) -> None:
    nn = n + 1
    l = nn.bit_length() - 1
    write_gamma(bb, l)
    bb.append_bits(nn ^ (1 << l), l)


def read_delta(r: BitReader) -> int:
    l = read_gamma(r)
    return (r.take(l) | (1 << l)) - 1


# ---------------------------------------------------------------------------
# compact_elias_fano
# ---------------------------------------------------------------------------


@dataclass
class EFOffsets:
    """compact_elias_fano.hpp:14-61 (field layout)."""

    universe: int
    n: int
    log_sampling0: int
    log_sampling1: int
    lower_bits: int
    higher_bits_length: int
    pointer_size: int
    pointers0: int
    pointers1: int
    pointers0_offset: int
    pointers1_offset: int
    higher_bits_offset: int
    lower_bits_offset: int
    end: int


def ef_offsets(base: int, universe: int, n: int, p: GlobalParameters) -> EFOffsets:
    universe, n = int(universe), int(n)
    assert n > 0
    lower_bits = (universe // n).bit_length() - 1 if universe > n else 0
    higher_bits_length = n + (universe >> lower_bits) + 2
    pointer_size = ceil_log2(higher_bits_length)
    pointers0 = (higher_bits_length - n) >> p.ef_log_sampling0
    pointers1 = n >> p.ef_log_sampling1
    pointers0_offset = base
    pointers1_offset = pointers0_offset + pointers0 * pointer_size
    higher_bits_offset = pointers1_offset + pointers1 * pointer_size
    lower_bits_offset = higher_bits_offset + higher_bits_length
    end = lower_bits_offset + n * lower_bits
    return EFOffsets(
        universe, n, p.ef_log_sampling0, p.ef_log_sampling1, lower_bits,
        higher_bits_length, pointer_size, pointers0, pointers1,
        pointers0_offset, pointers1_offset, higher_bits_offset,
        lower_bits_offset, end,
    )


class compact_elias_fano:
    @staticmethod
    def bitsize(p: GlobalParameters, universe: int, n: int) -> int:
        return ef_offsets(0, universe, n, p).end

    @staticmethod
    def write(bb: BitBuilder, values, universe: int, n: int,
              p: GlobalParameters) -> None:
        of = ef_offsets(bb.size, universe, n, p)
        base = bb.size
        bb.zero_extend(of.end - base)
        v = np.asarray(values, dtype=np.uint64)[:n]
        assert v.shape[0] == n
        i = np.arange(n, dtype=np.uint64)
        high = (v >> np.uint64(of.lower_bits)) + i + np.uint64(1)
        # high bits
        bb.set_ones(np.uint64(of.higher_bits_offset) + high)
        # low bits
        if of.lower_bits:
            low = v & np.uint64((1 << of.lower_bits) - 1)
            pos = (
                np.uint64(of.lower_bits_offset)
                + i * np.uint64(of.lower_bits)
            )
            bb.set_bits_batch(pos, low, of.lower_bits)
        # 1-pointers: for i multiple of 2^log_sampling1, 0 < i < n
        # (compact_elias_fano.hpp:120-126 writes inside the i<n loop, so
        # a slot whose sample index equals n stays zero)
        if of.pointers1:
            idx = np.arange(1, of.pointers1 + 1, dtype=np.int64)
            ii = idx << p.ef_log_sampling1
            keep = ii < n
            idx, ii = idx[keep], ii[keep]
            pos = (
                np.uint64(of.pointers1_offset)
                + (idx - 1).astype(np.uint64) * np.uint64(of.pointer_size)
            )
            bb.set_bits_batch(pos, high[ii], of.pointer_size)
        # 0-pointers: positions (within higher bits) of the ptr0<<log0-th zero
        if of.pointers0:
            # zeros in the higher-bits region: all positions except `high`
            # zero_rank(position) = position - ones_before(position)
            # we need position z_k of the (k<<log0)-th zero, k=1..pointers0
            idx = np.arange(1, of.pointers0 + 1, dtype=np.uint64)
            targets = idx << np.uint64(p.ef_log_sampling0)  # zero ranks
            # reference writes while (ptr0 << log0) < end_zeros — STRICT
            # (compact_elias_fano.hpp:91-99): a slot whose target equals
            # the total zero count stays zero
            total_zeros = np.uint64(of.higher_bits_length - n)
            keep = targets < total_zeros
            idx, targets = idx[keep], targets[keep]
            # stored slot = position of the zero with 0-based rank `target`
            # (compact_elias_fano.hpp set_ptr0s stores
            # (ptr0<<log0) + rank_end, i.e. pos = target + #ones before it).
            # A one at hs[j] precedes that zero iff the count of zeros
            # strictly before it (hs[j] - j) is <= target.
            hs = np.sort(high)
            zeros_before_one = hs - np.arange(hs.shape[0], dtype=np.uint64)
            k = np.searchsorted(zeros_before_one, targets, side="right")
            pos_of_zero = targets + k.astype(np.uint64)
            ptr_pos = (
                np.uint64(of.pointers0_offset)
                + (idx - np.uint64(1)) * np.uint64(of.pointer_size)
            )
            bb.set_bits_batch(ptr_pos, pos_of_zero, of.pointer_size)

    @staticmethod
    def decode_all(words: np.ndarray, offset: int, universe: int, n: int,
                   p: GlobalParameters) -> np.ndarray:
        of = ef_offsets(offset, universe, n, p)
        out = bitnative.ef_decode_fused(
            words, of.higher_bits_offset, of.higher_bits_length,
            of.lower_bits_offset, of.lower_bits, n,
        )
        if out is not None:
            return out
        rel = bitio.ones_positions(
            words, of.higher_bits_offset, of.higher_bits_offset + of.higher_bits_length
        )
        assert rel.shape[0] >= n, (rel.shape, n)
        rel = rel[:n].astype(np.uint64)
        i = np.arange(n, dtype=np.uint64)
        high = rel - i - np.uint64(1)
        if of.lower_bits:
            pos = np.uint64(of.lower_bits_offset) + i * np.uint64(of.lower_bits)
            low = bitio.read_fields(words, pos, of.lower_bits)
        else:
            low = np.zeros(n, dtype=np.uint64)
        return ((high << np.uint64(of.lower_bits)) | low).astype(np.uint64)


# ---------------------------------------------------------------------------
# compact_ranked_bitvector
# ---------------------------------------------------------------------------


class compact_ranked_bitvector:
    @staticmethod
    def _offsets(base: int, universe: int, n: int, p: GlobalParameters):
        rank1_sample_size = ceil_log2(n + 1)
        pointer_size = ceil_log2(universe)
        rank1_samples = universe >> p.rb_log_rank1_sampling
        pointers1 = n >> p.rb_log_sampling1
        rank1_samples_offset = base
        pointers1_offset = rank1_samples_offset + rank1_samples * rank1_sample_size
        bits_offset = pointers1_offset + pointers1 * pointer_size
        end = bits_offset + universe
        return (rank1_sample_size, pointer_size, rank1_samples, pointers1,
                rank1_samples_offset, pointers1_offset, bits_offset, end)

    @classmethod
    def bitsize(cls, p: GlobalParameters, universe: int, n: int) -> int:
        return cls._offsets(0, universe, n, p)[-1]

    @classmethod
    def write(cls, bb: BitBuilder, values, universe: int, n: int,
              p: GlobalParameters) -> None:
        (r1size, psize, r1samples, ptrs1, r1off, p1off, bits_off, end) = (
            cls._offsets(bb.size, universe, n, p)
        )
        base = bb.size
        bb.zero_extend(end - base)
        v = np.asarray(values, dtype=np.uint64)[:n]
        bb.set_ones(np.uint64(bits_off) + v)
        if ptrs1:
            idx = np.arange(1, ptrs1 + 1, dtype=np.int64)
            ii = idx << p.rb_log_sampling1
            # the reference's write loop runs i < n, so a pointer slot
            # landing exactly at i == n (n an exact multiple of
            # 2^log_sampling1) is allocated but never written (stays
            # zero) — compact_ranked_bitvector.hpp:101-106 quirk, same
            # family as the rank1-sample one below
            keep = ii < n
            idx, ii = idx[keep], ii[keep]
            pos = np.uint64(p1off) + (idx - 1).astype(np.uint64) * np.uint64(psize)
            bb.set_bits_batch(pos, v[ii], psize)
        if r1samples:
            idx = np.arange(1, r1samples + 1, dtype=np.uint64)
            sample_pos = idx << np.uint64(p.rb_log_rank1_sampling)
            # the reference's final set_rank1_samples bound is EXCLUSIVE
            # of `universe`, so a sample slot landing exactly at the
            # universe is allocated but never written (stays zero) —
            # compact_ranked_bitvector.hpp:102 (bit-parity quirk)
            keep = sample_pos < np.uint64(universe)
            idx, sample_pos = idx[keep], sample_pos[keep]
            ranks = np.searchsorted(v, sample_pos, side="left")
            pos = np.uint64(r1off) + (idx - np.uint64(1)) * np.uint64(r1size)
            bb.set_bits_batch(pos, ranks.astype(np.uint64), r1size)

    @classmethod
    def decode_all(cls, words, offset, universe, n, p) -> np.ndarray:
        bits_off = cls._offsets(offset, universe, n, p)[6]
        out = bitnative.select_all(words, bits_off, bits_off + universe, n)
        if out is not None:
            return out
        rel = bitio.ones_positions(words, bits_off, bits_off + universe)
        assert rel.shape[0] >= n
        return rel[:n].astype(np.uint64)


class all_ones_sequence:
    @staticmethod
    def bitsize(p, universe, n) -> int:
        return 0 if universe == n else (1 << 63)

    @staticmethod
    def write(bb, values, universe, n, p) -> None:
        assert universe == n

    @staticmethod
    def decode_all(words, offset, universe, n, p) -> np.ndarray:
        return np.arange(n, dtype=np.uint64)


# ---------------------------------------------------------------------------
# indexed_sequence (1-bit type tag; all_ones implicit)
# ---------------------------------------------------------------------------


class indexed_sequence:
    TYPE_BITS = 1

    @classmethod
    def _choose(cls, p, universe, n):
        best_cost = all_ones_sequence.bitsize(p, universe, n)
        best = "all_ones"
        ef = compact_elias_fano.bitsize(p, universe, n) + cls.TYPE_BITS
        if ef < best_cost:
            best_cost, best = ef, "ef"
        rb = compact_ranked_bitvector.bitsize(p, universe, n) + cls.TYPE_BITS
        if rb < best_cost:
            best_cost, best = rb, "rb"
        return best, best_cost

    @classmethod
    def bitsize(cls, p, universe, n) -> int:
        return cls._choose(p, universe, n)[1]

    @classmethod
    def write(cls, bb: BitBuilder, values, universe, n, p) -> None:
        best, cost = cls._choose(p, universe, n)
        if all_ones_sequence.bitsize(p, universe, n) != 0:
            bb.append_bits({"ef": 0, "rb": 1, "all_ones": 2}[best], cls.TYPE_BITS)
        if best == "ef":
            compact_elias_fano.write(bb, values, universe, n, p)
        elif best == "rb":
            compact_ranked_bitvector.write(bb, values, universe, n, p)

    @classmethod
    def decode_all(cls, words, offset, universe, n, p) -> np.ndarray:
        if all_ones_sequence.bitsize(p, universe, n) == 0:
            return all_ones_sequence.decode_all(words, offset, universe, n, p)
        t = bitio.read_bits_scalar(words, offset, cls.TYPE_BITS)
        off = offset + cls.TYPE_BITS
        if t == 0:
            return compact_elias_fano.decode_all(words, off, universe, n, p)
        return compact_ranked_bitvector.decode_all(words, off, universe, n, p)


# ---------------------------------------------------------------------------
# strict variants (strictly increasing; sampling of zeros disabled)
# ---------------------------------------------------------------------------


def _strict_params(p: GlobalParameters) -> GlobalParameters:
    sp = GlobalParameters(**p.__dict__)
    sp.ef_log_sampling0 = 63
    sp.rb_log_rank1_sampling = 63
    return sp


class strict_elias_fano:
    @staticmethod
    def bitsize(p, universe, n) -> int:
        assert universe >= n
        return compact_elias_fano.bitsize(p, universe - n + 1, n)

    @staticmethod
    def write(bb, values, universe, n, p) -> None:
        v = np.asarray(values, dtype=np.uint64)[:n]
        shifted = v - np.arange(n, dtype=np.uint64)
        compact_elias_fano.write(bb, shifted, universe - n + 1, n, p)

    @staticmethod
    def decode_all(words, offset, universe, n, p) -> np.ndarray:
        v = compact_elias_fano.decode_all(words, offset, universe - n + 1, n, p)
        return v + np.arange(n, dtype=np.uint64)


class strict_sequence:
    TYPE_BITS = 1

    @classmethod
    def _choose(cls, p, universe, n):
        sp = _strict_params(p)
        best_cost = all_ones_sequence.bitsize(p, universe, n)
        best = "all_ones"
        ef = strict_elias_fano.bitsize(sp, universe, n) + cls.TYPE_BITS
        if ef < best_cost:
            best_cost, best = ef, "ef"
        rb = compact_ranked_bitvector.bitsize(sp, universe, n) + cls.TYPE_BITS
        if rb < best_cost:
            best_cost, best = rb, "rb"
        return best, best_cost

    @classmethod
    def bitsize(cls, p, universe, n) -> int:
        return cls._choose(p, universe, n)[1]

    @classmethod
    def write(cls, bb, values, universe, n, p) -> None:
        sp = _strict_params(p)
        best, _ = cls._choose(p, universe, n)
        if all_ones_sequence.bitsize(p, universe, n) != 0:
            bb.append_bits({"ef": 0, "rb": 1, "all_ones": 2}[best], cls.TYPE_BITS)
        if best == "ef":
            strict_elias_fano.write(bb, values, universe, n, sp)
        elif best == "rb":
            compact_ranked_bitvector.write(bb, values, universe, n, sp)

    @classmethod
    def decode_all(cls, words, offset, universe, n, p) -> np.ndarray:
        sp = _strict_params(p)
        if all_ones_sequence.bitsize(p, universe, n) == 0:
            return np.arange(n, dtype=np.uint64)
        t = bitio.read_bits_scalar(words, offset, cls.TYPE_BITS)
        off = offset + cls.TYPE_BITS
        if t == 0:
            return strict_elias_fano.decode_all(words, off, universe, n, sp)
        return compact_ranked_bitvector.decode_all(words, off, universe, n, sp)


class positive_sequence:
    """Positive values stored as prefix sums (positive_sequence.hpp:15-30)."""

    def __init__(self, base=strict_sequence):
        self.base = base

    def write(self, bb, values, universe, n, p) -> None:
        v = np.asarray(values, dtype=np.uint64)[:n]
        assert (v > 0).all()
        self.base.write(bb, np.cumsum(v), universe, n, p)

    def decode_all(self, words, offset, universe, n, p) -> np.ndarray:
        c = self.base.decode_all(words, offset, universe, n, p).astype(np.int64)
        out = np.empty(n, dtype=np.uint64)
        out[0] = c[0]
        out[1:] = (c[1:] - c[:-1]).astype(np.uint64)
        return out


# ---------------------------------------------------------------------------
# optimal_partition (the PEF partitioning DP, optimal_partition.hpp:69-121)
# ---------------------------------------------------------------------------


def optimal_partition(values: np.ndarray, universe: int, cost_fun,
                      eps1: float, eps2: float) -> List[int]:
    size = int(values.shape[0])
    single_block_cost = cost_fun(universe, size)
    min_cost = np.full(size + 1, single_block_cost, dtype=np.float64)
    min_cost[0] = 0
    cost_lb = cost_fun(1, 1)
    bounds = []
    cost_bound = cost_lb
    while eps1 == 0 or cost_bound < cost_lb / eps1:
        bounds.append(cost_bound)
        if cost_bound >= single_block_cost:
            break
        cost_bound = cost_bound * (1 + eps2)

    class Window:
        __slots__ = ("start", "end", "min_p", "max_p", "bound")

        def __init__(self, bound):
            self.start = 0
            self.end = 0
            self.min_p = int(values[0]) if size else 0
            self.max_p = 0
            self.bound = bound

    windows = [Window(b) for b in bounds]
    path = np.zeros(size + 1, dtype=np.int64)
    for i in range(size):
        last_end = i + 1
        for w in windows:
            while w.end < last_end:
                w.max_p = int(values[w.end])
                w.end += 1
            while True:
                window_cost = cost_fun(w.max_p - w.min_p + 1, w.end - w.start)
                if min_cost[i] + window_cost < min_cost[w.end]:
                    min_cost[w.end] = min_cost[i] + window_cost
                    path[w.end] = i
                last_end = w.end
                if w.end == size:
                    break
                if window_cost >= w.bound:
                    break
                w.max_p = int(values[w.end])
                w.end += 1
            w.min_p = int(values[w.start]) + 1
            w.start += 1
    partition = []
    cur = size
    while cur != 0:
        partition.append(cur)
        cur = int(path[cur])
    partition.reverse()
    return partition


# ---------------------------------------------------------------------------
# partitioned / uniform partitioned sequences
# ---------------------------------------------------------------------------


class _partitioned_base:
    """Shared writer/reader for partitioned_sequence (variable partitions)
    and uniform_partitioned_sequence (fixed 2^log_partition_size)."""

    def __init__(self, base=indexed_sequence, uniform=False):
        self.base = base
        self.uniform = uniform

    def _partition_points(self, values, universe, n, p) -> List[int]:
        if self.uniform:
            ps = 1 << p.log_partition_size
            return list(range(ps, n, ps)) + [n]
        strict = self.base is strict_sequence
        if strict or self.base is indexed_sequence:
            # native DP (same arithmetic/closed-form costs; parity-
            # gated in tests) — the python loop below is the oracle
            part = bitnative.opt_partition(
                values, universe, p, CONF.eps1, CONF.eps2, CONF.fix_cost,
                strict,
            )
            if part is not None:
                return part
        cost = lambda u, m: self.base.bitsize(p, u, m) + CONF.fix_cost
        return optimal_partition(values, universe, cost, CONF.eps1, CONF.eps2)

    def write(self, bb: BitBuilder, values, universe: int, n: int,
              p: GlobalParameters) -> None:
        assert n > 0
        values = np.asarray(values, dtype=np.uint64)[:n]
        partition = self._partition_points(values, universe, n, p)
        partitions = len(partition)
        write_gamma_nonzero(bb, partitions)
        if partitions == 1:
            cur_base = int(values[0])
            rel = values - np.uint64(cur_base)
            bb.append_bits(cur_base, ceil_log2(universe))
            if n > 1:
                if cur_base + int(rel[-1]) + 1 == universe:
                    write_delta(bb, 0)  # tight universe
                else:
                    write_delta(bb, int(rel[-1]))
            self.base.write(bb, rel, int(rel[-1]) + 1, n, p)
            return
        seq_bb = BitBuilder()
        endpoints = []
        upper_bounds = [int(values[0])]
        cur_base = int(values[0])
        cur_i = 0
        for endpos in partition:
            part = values[cur_i:endpos]
            ub = int(part[-1])
            rel = part - np.uint64(cur_base)
            self.base.write(seq_bb, rel, int(rel[-1]) + 1, part.shape[0], p)
            endpoints.append(seq_bb.size)
            upper_bounds.append(ub)
            cur_base = ub + 1
            cur_i = endpos
        if not self.uniform:
            sizes_bb = BitBuilder()
            compact_elias_fano.write(sizes_bb, partition[:-1], n, partitions - 1, p)
        ub_bb = BitBuilder()
        compact_elias_fano.write(ub_bb, upper_bounds, universe, partitions + 1, p)
        endpoint_bits = ceil_log2(seq_bb.size + 1)
        write_gamma(bb, endpoint_bits)
        if not self.uniform:
            bb.append(sizes_bb)
        bb.append(ub_bb)
        for e in endpoints[:-1]:
            bb.append_bits(e, endpoint_bits)
        bb.append(seq_bb)

    def decode_all(self, words, offset: int, universe: int, n: int,
                   p: GlobalParameters) -> np.ndarray:
        if self.base is indexed_sequence or self.base is strict_sequence:
            out = bitnative.pef_decode_all(
                words, offset, universe, n, p, self.uniform,
                self.base is strict_sequence,
            )
            if out is not None:
                return out
        r = BitReader(words, offset)
        partitions = read_gamma(r) + 1
        if partitions == 1:
            cur_base = r.take(ceil_log2(universe))
            if n > 1:
                ub = read_delta(r)
                part_universe = (universe - cur_base) if ub == 0 else ub + 1
            else:
                part_universe = 1
            rel = self.base.decode_all(words, r.pos, part_universe, n, p)
            return rel + np.uint64(cur_base)
        endpoint_bits = read_gamma(r)
        pos = r.pos
        if not self.uniform:
            so = ef_offsets(pos, n, partitions - 1, p)
            sizes = compact_elias_fano.decode_all(words, pos, n, partitions - 1, p)
            pos = so.end
            partition = list(sizes.astype(np.int64)) + [n]
        else:
            ps = 1 << p.log_partition_size
            partition = list(range(ps, n, ps)) + [n]
        uo = ef_offsets(pos, universe, partitions + 1, p)
        ubs = compact_elias_fano.decode_all(words, pos, universe, partitions + 1, p)
        pos = uo.end
        endpoints = [0]
        for k in range(partitions - 1):
            endpoints.append(bitio.read_bits_scalar(words, pos, endpoint_bits))
            pos += endpoint_bits
        seq_base = pos  # endpoints loop above already advanced pos
        out = np.zeros(n, dtype=np.uint64)
        cur_i = 0
        cur_base = int(ubs[0])
        for k, endpos in enumerate(partition):
            m = endpos - cur_i
            ub = int(ubs[k + 1])
            rel_universe = ub - cur_base + 1
            rel = self.base.decode_all(
                words, seq_base + endpoints[k], rel_universe, m, p
            )
            out[cur_i:endpos] = rel + np.uint64(cur_base)
            cur_base = ub + 1
            cur_i = endpos
        return out


def partitioned_sequence(base=indexed_sequence):
    return _partitioned_base(base, uniform=False)


def uniform_partitioned_sequence(base=indexed_sequence):
    return _partitioned_base(base, uniform=True)
