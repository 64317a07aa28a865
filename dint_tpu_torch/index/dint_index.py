"""DINT frequency index — the dict_freq_index equivalent (host copy).

The port's own copy of ``dint_tpu/index/dint_index.py``.  Its files are
the reference package's: what one package saves, the other loads.

Layout semantics mirror dict_posting_list.hpp:10-56 / dict_freq_index.hpp:
posting lists are chopped into 256-int blocks; per list the index holds
the list length, per-block last-docIDs (block_maxs), per-block end
offsets (the skip data), and the concatenated per-block payloads, where
each block stores its docID d-gaps followed by its freq-1 values, both
DINT-coded (blocks shorter than 256 fall back to interpolative coding
with the docs' gap-universe known and the freqs' sum unknown —
dint_codecs.hpp:17-19, dict_posting_list.hpp:44-48).

The index is a structure of arrays — a flat payload arena plus dense
per-list and per-block tables — so whole batches of blocks decode in
parallel on the device.  The serialized stats count the reference's
bytes (vbyte length + 4B block_max/block + 4B endpoint/(block-1) +
payloads), so bpi is comparable line-for-line with the reference's
dump_stats (index_build_utils.hpp:91-118).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..codecs import dint, encode_batch, interpolative, vbyte
from ..config import BLOCK_SIZE, NUM_SELECTORS
from ..dictionary import builder as dict_builder
from ..io.collection import open_freq_collection
from ..tools import common as tools_common

MAGIC = b"DINTTPU1"

# global_parameters.hpp:5-31, the two fields compact_elias_fano reads
EF_LOG_SAMPLING0 = 9
EF_LOG_SAMPLING1 = 8


def ef_bitsize(universe: int, n: int) -> int:
    """Bit size of a compact Elias-Fano sequence of ``n`` values below
    ``universe`` (compact_elias_fano.hpp:14-61): a closed function of
    (universe, n), copied from the reference package's
    ``codecs/ef.py`` ``ef_offsets(...).end``."""
    universe, n = int(universe), int(n)
    assert n > 0
    lower_bits = (universe // n).bit_length() - 1 if universe > n else 0
    higher_bits_length = n + (universe >> lower_bits) + 2
    pointer_size = (higher_bits_length - 1).bit_length() \
        if higher_bits_length > 1 else 0
    pointers0 = (higher_bits_length - n) >> EF_LOG_SAMPLING0
    pointers1 = n >> EF_LOG_SAMPLING1
    return ((pointers0 + pointers1) * pointer_size + higher_bits_length
            + n * lower_bits)


@dataclass
class DintIndex:
    kind: str  # 'single' | 'rectangular' | 'multi'
    policy: Optional[str]
    num_docs: int
    list_n: np.ndarray  # (L,) u32
    block_ptr: np.ndarray  # (L+1,) u64 first block id per list
    block_max: np.ndarray  # (NB,) u32 last docid per block
    docs_end: np.ndarray  # (NB,) u64 arena offset past the block's docs part
    block_end: np.ndarray  # (NB,) u64 arena offset past the whole block
    arena: np.ndarray  # (T,) u8 concatenated block payloads
    docs_dict: object = None
    freqs_dict: object = None

    # ---- derived ----
    @property
    def num_lists(self) -> int:
        return int(self.list_n.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_max.shape[0])

    def list_blocks(self, i: int) -> Tuple[int, int]:
        return int(self.block_ptr[i]), int(self.block_ptr[i + 1])

    def block_start(self, b: int) -> int:
        return int(self.block_end[b - 1]) if b > 0 else 0

    # ---- size accounting (reference-equivalent) ----
    def endpoint_directory_bits(self) -> int:
        """EXACT bit count of the EF-coded list directory — the
        m_endpoints analogue (dict_freq_index.hpp:97-100: compact EF
        over the per-list start offsets, universe = payload byte size,
        n = num_lists)."""
        u = max(int(self.arena.shape[0]), 1)
        return ef_bitsize(u, self.num_lists)

    def size_stats(self) -> dict:
        """Reference-style byte split (index_build_utils.hpp:37-88):
        freqs = per-block freq payload bytes; docs = everything else
        (headers, maxs, endpoints, docs payloads, list directory)."""
        L = self.num_lists
        NB = self.num_blocks
        header_bytes = sum(vbyte.encoded_size(int(n)) for n in self.list_n)
        starts = np.concatenate([[0], self.block_end[:-1]])
        freq_bytes = int((self.block_end - self.docs_end).sum())
        docs_payload = int((self.docs_end - starts).sum())
        maxs_bytes = 4 * NB
        endpoint_bytes = 4 * (NB - L)  # last block of each list implied
        ef_bits = self.endpoint_directory_bits()
        postings = int(self.list_n.astype(np.int64).sum())
        docs_bytes = header_bytes + maxs_bytes + endpoint_bytes + docs_payload + -(-ef_bits // 8)
        return {
            "postings": postings,
            "docs_bytes": docs_bytes,
            "freqs_bytes": freq_bytes,
            "docs_bpi": docs_bytes * 8.0 / max(postings, 1),
            "freqs_bpi": freq_bytes * 8.0 / max(postings, 1),
        }

    # ---- persistence (freeze/map analogue of succinct::mapper) ----
    def save(self, path: str) -> None:
        np.savez(
            path,
            magic=np.frombuffer(MAGIC, dtype=np.uint8),
            kind=np.frombuffer(self.kind.encode(), dtype=np.uint8),
            policy=np.frombuffer((self.policy or "").encode(), dtype=np.uint8),
            num_docs=np.asarray([self.num_docs], dtype=np.uint64),
            list_n=self.list_n,
            block_ptr=self.block_ptr,
            block_max=self.block_max,
            # docs_end is NOT serialized: the reference stores only one
            # endpoint per block (the freqs start is implied by decoding
            # the docs half, dict_posting_list.hpp:298-302); it is
            # recovered at load time by ensure_docs_end.
            block_end=self.block_end,
            arena=self.arena,
        )
        base = path[:-4] if path.endswith(".npz") else path
        if self.docs_dict is not None:
            self.docs_dict.store(base + ".docsdict")
        if self.freqs_dict is not None:
            self.freqs_dict.store(base + ".freqsdict")

    @classmethod
    def load(cls, path: str) -> "DintIndex":
        from ..dictionary.dictionary import (
            MultiPackedDictionary,
            PackedDictionary,
            RectangularDictionary,
        )

        base = path[:-4] if path.endswith(".npz") else path
        z = np.load(base + ".npz")
        assert z["magic"].tobytes() == MAGIC
        kind = z["kind"].tobytes().decode()
        policy = z["policy"].tobytes().decode() or None
        docs_dict = freqs_dict = None
        if os.path.exists(base + ".docsdict"):
            if kind == "rectangular":
                loader = RectangularDictionary.load
            elif kind == "multi":
                loader = lambda p: MultiPackedDictionary.load(p, policy or "pack")
            else:
                loader = lambda p: PackedDictionary.load(p, policy or "pack")
            docs_dict = loader(base + ".docsdict")
            freqs_dict = loader(base + ".freqsdict")
        return cls(
            kind,
            policy,
            int(z["num_docs"][0]),
            z["list_n"],
            z["block_ptr"],
            z["block_max"],
            None,  # docs_end recovered lazily (see save())
            z["block_end"],
            z["arena"],
            docs_dict,
            freqs_dict,
        )

    def ensure_docs_end(self) -> None:
        """Recover per-block docs/freqs split offsets after load.

        Parses every block's docs half once — the load-time analogue of
        the enumerator's sequential discovery.  Full DINT blocks batch
        through the vectorized parser (query/lazy_decode.py, chunked to
        bound memory); partial interpolative blocks walk individually."""
        if self.docs_end is not None:
            return
        from ..query.lazy_decode import decode_units_fast_batch

        view = self.docs_dict.decode_view()
        NB = self.num_blocks
        docs_end = np.zeros(NB, dtype=np.uint64)
        multi = self.kind == "multi"
        f_start, f_lim, f_sz, f_ctx, f_b, f_ids = [], [], [], [], [], []

        def flush():
            if not f_start:
                return
            _, consumed = decode_units_fast_batch(
                self.arena, f_start, f_lim, f_sz, view, f_ctx, f_b
            )
            for b, s, c in zip(f_ids, f_start, consumed):
                docs_end[b] = s + int(c)
            f_start.clear(); f_lim.clear(); f_sz.clear()
            f_ctx.clear(); f_b.clear(); f_ids.clear()

        for i in range(self.num_lists):
            p0, p1 = self.list_blocks(i)
            n = int(self.list_n[i])
            for b in range(p0, p1):
                pos = (b - p0) * BLOCK_SIZE
                size = min(BLOCK_SIZE, n - pos)
                start = self.block_start(b)
                base = int(self.block_max[b - 1]) + 1 if b > p0 else 0
                if size < BLOCK_SIZE:
                    sum_v = int(self.block_max[b]) - base - (size - 1)
                    _, end = interpolative.decode_block(
                        self.arena, start, size, sum_v
                    )
                    docs_end[b] = end
                    continue
                s = start
                if multi:
                    sc = int(self.arena[s])
                    f_ctx.append(sc % NUM_SELECTORS)
                    f_b.append(16 if sc < NUM_SELECTORS else 8)
                    s += 1
                else:
                    f_ctx.append(0)
                    f_b.append(16)
                f_start.append(s)
                f_lim.append(int(self.block_end[b]))
                f_sz.append(size)
                f_ids.append(b)
                if len(f_start) >= 16384:
                    flush()
        flush()
        self.docs_end = docs_end


def _encode_blocks(
    d, kind: str, units: List[np.ndarray], sums: List[int]
) -> List[bytes]:
    """Encode per-block units: DINT for full blocks, interpolative else."""
    full_idx = [i for i, u in enumerate(units) if len(u) == BLOCK_SIZE]
    out: List[bytes] = [b""] * len(units)
    if full_idx:
        full_units = [units[i] for i in full_idx]
        if kind == "multi":
            streams, _ = encode_batch.encode_multi_lists(d, full_units)
        else:
            streams, _ = encode_batch.encode_single_lists(d, full_units)
        for i, s in zip(full_idx, streams):
            out[i] = s
    for i, u in enumerate(units):
        if len(u) < BLOCK_SIZE:
            out[i] = interpolative.encode_block(u, sums[i])
    return out


def build_index(
    basename: str,
    kind: str = "single",
    policy: str = "pack",
    cache_dir: str = ".",
    list_range: Optional[Tuple[int, int]] = None,
) -> DintIndex:
    """create_freq_index equivalent (src/create_freq_index.cpp:54-110).

    ``list_range=(a, b)`` restricts the build to lists [a, b) (one shard
    of a build split by lists; shard outputs concatenate in order into
    an index identical to the whole build).  Dictionaries are always
    trained on (or loaded from the cache of) the FULL collection,
    matching the reference's train-once model.
    """
    view = open_freq_collection(basename)
    tools_common.log("building or loading dictionaries (docs, freqs)...")
    docs_dict = dict_builder.build_or_load_dict(
        basename + ".docs", True, kind, policy, cache_dir
    )
    freqs_dict = dict_builder.build_or_load_dict(
        basename + ".freqs", False, kind, policy, cache_dir
    )

    tools_common.log("encoding posting lists...")
    # ---- vectorized geometry over the whole collection (no per-list
    # Python loop: flat gap transforms with per-list resets, block
    # bounds by arithmetic, block maxes by one gather) ----
    dvals, doffs, dlens = view.docs.flat_view()
    fvals, foffs, flens = view.freqs.flat_view()
    L = len(view)
    a, b = list_range if list_range is not None else (0, L)
    assert 0 <= a <= b <= L, (a, b, L)
    if list_range is None:
        list_n = np.asarray(dlens[1:], dtype=np.int64)  # seq 0 = num_docs
        # payload concat = word stream minus length words (+ singleton)
        drop_d = np.concatenate([np.asarray(doffs, np.int64), [1]])
        docs_flat = np.delete(np.asarray(dvals, dtype=np.uint32), drop_d)
        freqs_flat = np.delete(
            np.asarray(fvals, dtype=np.uint32), np.asarray(foffs, np.int64)
        )
    else:
        # List i lives at docs sequence i+1 (seq 0 = num_docs singleton)
        # and freqs sequence i; slice each word stream to the range and
        # drop the in-range length words.
        doffs = np.asarray(doffs, np.int64)
        foffs = np.asarray(foffs, np.int64)
        d_lo = int(doffs[1 + a]) if 1 + a < doffs.shape[0] else len(dvals)
        d_hi = int(doffs[1 + b]) if 1 + b < doffs.shape[0] else len(dvals)
        f_lo = int(foffs[a]) if a < foffs.shape[0] else len(fvals)
        f_hi = int(foffs[b]) if b < foffs.shape[0] else len(fvals)
        list_n = np.asarray(dlens[1 + a : 1 + b], dtype=np.int64)
        docs_flat = np.delete(
            np.asarray(dvals[d_lo:d_hi], dtype=np.uint32),
            doffs[1 + a : 1 + b] - d_lo,
        )
        freqs_flat = np.delete(
            np.asarray(fvals[f_lo:f_hi], dtype=np.uint32),
            foffs[a:b] - f_lo,
        )
        L = b - a
    # u32-native gap transforms: docids increase strictly within a
    # list so u32 subtraction never wraps (cross-list positions may
    # wrap but are overwritten below), and freqs are >= 1.
    dgap = np.empty_like(docs_flat)
    lstart = np.cumsum(list_n) - list_n
    if docs_flat.shape[0]:
        np.subtract(docs_flat[1:], docs_flat[:-1], out=dgap[1:])
        dgap[1:] -= 1
        dgap[0] = docs_flat[0]
    ne = lstart[list_n > 0]
    dgap[ne] = docs_flat[ne]  # first gap of each list = its first docid
    fgap = freqs_flat
    fgap -= 1  # in place; freqs_flat is not read again

    nb = -(-list_n // BLOCK_SIZE)
    block_ptr = np.concatenate([[0], np.cumsum(nb)])
    NB = int(nb.sum())
    blist = np.repeat(np.arange(L, dtype=np.int64), nb)
    pos_in_list = (
        np.arange(NB, dtype=np.int64) - block_ptr[:-1][blist]
    ) * BLOCK_SIZE
    abs_start = lstart[blist] + pos_in_list
    bsize = np.minimum(BLOCK_SIZE, list_n[blist] - pos_in_list)
    block_max = docs_flat[abs_start + bsize - 1].astype(np.int64)
    first = pos_in_list == 0
    base = np.where(
        first, 0, docs_flat[np.maximum(abs_start - 1, 0)].astype(np.int64) + 1
    )
    doc_sums_arr = block_max - base - (bsize - 1)

    doc_units = [dgap[abs_start[b] : abs_start[b] + bsize[b]] for b in range(NB)]
    freq_units = [fgap[abs_start[b] : abs_start[b] + bsize[b]] for b in range(NB)]
    doc_sums = doc_sums_arr.tolist()
    freq_sums = [interpolative.UNKNOWN_SUM] * NB

    doc_payloads = _encode_blocks(docs_dict, kind, doc_units, doc_sums)
    freq_payloads = _encode_blocks(freqs_dict, kind, freq_units, freq_sums)

    d_lens = np.fromiter((len(p) for p in doc_payloads), np.int64, NB)
    f_lens = np.fromiter((len(p) for p in freq_payloads), np.int64, NB)
    ends = np.cumsum(
        np.stack([d_lens, f_lens], axis=1).reshape(-1)
    ).reshape(NB, 2)
    docs_end = ends[:, 0].astype(np.uint64)
    block_end = ends[:, 1].astype(np.uint64)
    parts: List[bytes] = [b""] * (2 * NB)
    parts[0::2] = doc_payloads
    parts[1::2] = freq_payloads
    arena = np.frombuffer(b"".join(parts), dtype=np.uint8)

    return DintIndex(
        kind,
        policy,
        view.num_docs,
        list_n.astype(np.uint32),
        block_ptr.astype(np.uint64),
        block_max.astype(np.uint32),
        docs_end,
        block_end,
        arena,
        docs_dict,
        freqs_dict,
    )


# ---------------------------------------------------------------------------
# Oracle (host) readers — the executable spec for the device query path.
# ---------------------------------------------------------------------------


def decode_block_docs_host(index: DintIndex, b: int, list_i: int) -> np.ndarray:
    """Decode block b's docIDs (host oracle; dict_posting_list.hpp:284-309)."""
    p0, p1 = index.list_blocks(list_i)
    assert p0 <= b < p1
    n = int(index.list_n[list_i])
    pos_in_list = (b - p0) * BLOCK_SIZE
    size = min(BLOCK_SIZE, n - pos_in_list)
    base = int(index.block_max[b - 1]) + 1 if b > p0 else 0
    start = index.block_start(b)
    view = index.docs_dict.decode_view()
    out = np.zeros(size, dtype=np.uint32)
    if size < BLOCK_SIZE:
        sum_v = int(index.block_max[b]) - base - (size - 1)
        vals, _ = interpolative.decode_block(index.arena, start, size, sum_v)
        out[:] = vals
    elif index.kind == "multi":
        dint.decode_multi(view, index.arena, start, size, out)
    else:
        dint.decode_single(view, index.arena, start, size, out)
    docs = np.cumsum(out.astype(np.int64) + 1) - 1 + base
    return docs.astype(np.uint32)


def decode_block_freqs_host(index: DintIndex, b: int, list_i: int) -> np.ndarray:
    p0, p1 = index.list_blocks(list_i)
    n = int(index.list_n[list_i])
    pos_in_list = (b - p0) * BLOCK_SIZE
    size = min(BLOCK_SIZE, n - pos_in_list)
    start = int(index.docs_end[b])
    view = index.freqs_dict.decode_view()
    out = np.zeros(size, dtype=np.uint32)
    if size < BLOCK_SIZE:
        vals, _ = interpolative.decode_block(
            index.arena, start, size, interpolative.UNKNOWN_SUM
        )
        out[:] = vals
    elif index.kind == "multi":
        dint.decode_multi(view, index.arena, start, size, out)
    else:
        dint.decode_single(view, index.arena, start, size, out)
    return (out.astype(np.int64) + 1).astype(np.uint32)


def list_docids_host(index: DintIndex, i: int) -> np.ndarray:
    p0, p1 = index.list_blocks(i)
    return np.concatenate(
        [decode_block_docs_host(index, b, i) for b in range(p0, p1)]
    )


def list_freqs_host(index: DintIndex, i: int) -> np.ndarray:
    p0, p1 = index.list_blocks(i)
    return np.concatenate(
        [decode_block_freqs_host(index, b, i) for b in range(p0, p1)]
    )


def decode_index_host(index: DintIndex) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Every posting of the index decoded on the host in one batch: the
    full DINT blocks through the native unit decoder
    (``query/native_host.decode_units_flat``, one call per half), the
    partial blocks through ``interpolative.decode_blocks_batch``.
    Returns (docids, freqs, offsets): list i's postings are
    ``[offsets[i], offsets[i + 1])``.  The same values as
    ``list_docids_host`` / ``list_freqs_host`` list by list."""
    from ..query import native_host

    index.ensure_docs_end()
    bp = index.block_ptr.astype(np.int64)
    list_n = index.list_n.astype(np.int64)
    offsets = np.zeros(list_n.shape[0] + 1, dtype=np.int64)
    np.cumsum(list_n, out=offsets[1:])
    lst = np.repeat(np.arange(list_n.shape[0]), bp[1:] - bp[:-1])
    blk = np.arange(bp[-1], dtype=np.int64)
    first = bp[lst]
    pos = (blk - first) * BLOCK_SIZE
    size = np.minimum(BLOCK_SIZE, list_n[lst] - pos)
    block_max = index.block_max.astype(np.int64)
    base = np.where(blk > first, np.concatenate([[0], block_max[:-1] + 1]), 0)
    block_end = index.block_end.astype(np.int64)
    docs_start = np.concatenate([[0], block_end[:-1]])
    docs_end = index.docs_end.astype(np.int64)
    out_at = offsets[lst] + pos
    full = np.flatnonzero(size == BLOCK_SIZE)
    part = np.flatnonzero(size < BLOCK_SIZE)
    lanes = np.arange(BLOCK_SIZE, dtype=np.int64)
    docs = np.zeros(int(offsets[-1]), dtype=np.uint32)
    freqs = np.zeros(int(offsets[-1]), dtype=np.uint32)
    for half, (s, e, view) in enumerate((
            (docs_start, docs_end, index.docs_dict.decode_view()),
            (docs_end, block_end, index.freqs_dict.decode_view()))):
        if full.size:
            s_f, e_f = s[full], e[full]
            if index.kind == "multi":
                sc = index.arena[s_f].astype(np.int64)
                ctx = sc % NUM_SELECTORS
                b_bits = np.where(sc < NUM_SELECTORS, 16, 8)
                s_f = s_f + 1
            else:
                ctx = np.zeros(full.shape[0], np.int64)
                b_bits = np.full(full.shape[0], 16)
            vals = native_host.decode_units_flat(
                view, index.arena, s_f, e_f - s_f,
                np.full(full.shape[0], BLOCK_SIZE), ctx, b_bits,
            ).reshape(-1, BLOCK_SIZE).astype(np.int64)
            if half == 0:
                vals = np.cumsum(vals + 1, axis=1) - 1 + base[full][:, None]
            else:
                vals = vals + 1
            (docs if half == 0 else freqs)[
                out_at[full][:, None] + lanes] = vals.astype(np.uint32)
        if part.size:
            if half == 0:
                specs = [(int(s[b]), int(size[b]),
                          int(block_max[b] - base[b] - (size[b] - 1)))
                         for b in part]
            else:
                specs = [(int(s[b]), int(size[b]), interpolative.UNKNOWN_SUM)
                         for b in part]
            for b, v in zip(part, interpolative.decode_blocks_batch(
                    index.arena, specs)):
                v = v.astype(np.int64)
                v = np.cumsum(v + 1) - 1 + base[b] if half == 0 else v + 1
                (docs if half == 0 else freqs)[
                    out_at[b]:out_at[b] + size[b]] = v.astype(np.uint32)
    return docs, freqs, offsets


def verify_index(index: DintIndex, basename: str) -> None:
    """verify_collection equivalent (verify_collection.hpp:7-52): every
    docid and freq of every list, decoded by ``decode_index_host``,
    equal to the collection's."""
    docs_all, freqs_all, offs = decode_index_host(index)
    view = open_freq_collection(basename)
    for i, (docs, freqs) in enumerate(view):
        if not np.array_equal(docs_all[offs[i]:offs[i + 1]], docs):
            raise SystemExit(f"docid mismatch in list {i}")
        if not np.array_equal(freqs_all[offs[i]:offs[i + 1]], freqs):
            raise SystemExit(f"freq mismatch in list {i}")
