"""Blocked frequency index over the codec zoo — block_freq_index rebuild
(host copy of ``dint_tpu/index/block_index.py``).

Same 256-int blocked layout as the DINT index (block_posting_list.hpp:
14-53 is the dictionary-less twin of dict_posting_list), with per-block
payloads produced by any codec from codecs/blocks.py; the 11 block
index types of index_types.hpp:39-49 are `BlockIndex(codec=...)`.

The SoA arrays match dint_index.DintIndex; the docs/freqs split offset
is serialized-free and recovered at load (see DintIndex.save notes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..backend import resolve_device
from ..codecs import blocks as blocks_mod
from ..codecs import interpolative, vbyte
from ..config import BLOCK_SIZE
from ..io.collection import open_freq_collection
from ..tools import common as tools_common
from ..utils import block_profiler
from ..utils import gaps as gap_mod

MAGIC = b"BLKTPU1"


def _codec(name: str):
    if name == "mixed" and "mixed" not in blocks_mod.CODECS:
        from . import mixed_block  # noqa: F401  (registers the codec)
    return blocks_mod.CODECS[name]


@dataclass
class BlockIndex:
    codec: str
    num_docs: int
    list_n: np.ndarray
    block_ptr: np.ndarray
    block_max: np.ndarray
    docs_end: Optional[np.ndarray]
    block_end: np.ndarray
    arena: np.ndarray

    @property
    def num_lists(self) -> int:
        return int(self.list_n.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_max.shape[0])

    def list_blocks(self, i: int):
        return int(self.block_ptr[i]), int(self.block_ptr[i + 1])

    def block_start(self, b: int) -> int:
        return int(self.block_end[b - 1]) if b > 0 else 0

    def size_stats(self) -> dict:
        L, NB = self.num_lists, self.num_blocks
        self.ensure_docs_end()
        header_bytes = sum(vbyte.encoded_size(int(n)) for n in self.list_n)
        starts = np.concatenate([[0], self.block_end[:-1]])
        freq_bytes = int((self.block_end - self.docs_end).sum())
        docs_payload = int((self.docs_end - starts).sum())
        postings = int(self.list_n.astype(np.int64).sum())
        docs_bytes = header_bytes + 4 * NB + 4 * (NB - L) + docs_payload
        return {
            "postings": postings,
            "docs_bpi": docs_bytes * 8.0 / max(postings, 1),
            "freqs_bpi": freq_bytes * 8.0 / max(postings, 1),
        }

    def save(self, path: str) -> None:
        np.savez(
            path,
            magic=np.frombuffer(MAGIC, dtype=np.uint8),
            codec=np.frombuffer(self.codec.encode(), dtype=np.uint8),
            num_docs=np.asarray([self.num_docs], np.uint64),
            list_n=self.list_n,
            block_ptr=self.block_ptr,
            block_max=self.block_max,
            block_end=self.block_end,
            arena=self.arena,
        )

    @classmethod
    def load(cls, path: str) -> "BlockIndex":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        assert z["magic"].tobytes() == MAGIC
        return cls(
            z["codec"].tobytes().decode(),
            int(z["num_docs"][0]),
            z["list_n"],
            z["block_ptr"],
            z["block_max"],
            None,
            z["block_end"],
            z["arena"],
        )

    # ---- block decode (host oracle; devices reuse the DINT machinery
    # for DINT payloads — codec-zoo device kernels are future work) ----
    def _block_geom(self, b: int, i: int):
        p0, p1 = self.list_blocks(i)
        n = int(self.list_n[i])
        pos = (b - p0) * BLOCK_SIZE
        size = min(BLOCK_SIZE, n - pos)
        base = int(self.block_max[b - 1]) + 1 if b > p0 else 0
        return size, base

    def block_docs(self, b: int, i: int) -> np.ndarray:
        size, base = self._block_geom(b, i)
        sum_v = int(self.block_max[b]) - base - (size - 1)
        dec = _codec(self.codec)[1]
        gaps, _ = dec(self.arena, self.block_start(b), size, sum_v)
        if block_profiler.is_enabled():  # block_posting_list.hpp:96-99
            block_profiler.open_list(i, int(self.block_ptr[i + 1] - self.block_ptr[i]))
            block_profiler.count_docs(i, b - int(self.block_ptr[i]))
        return (np.cumsum(gaps.astype(np.int64) + 1) - 1 + base).astype(np.uint32)

    def block_freqs(self, b: int, i: int) -> np.ndarray:
        size, _ = self._block_geom(b, i)
        self.ensure_docs_end()
        dec = _codec(self.codec)[1]
        vals, _ = dec(self.arena, int(self.docs_end[b]), size, blocks_mod.UNKNOWN)
        if block_profiler.is_enabled():  # block_posting_list.hpp:316-330
            block_profiler.open_list(i, int(self.block_ptr[i + 1] - self.block_ptr[i]))
            block_profiler.count_freqs(i, b - int(self.block_ptr[i]))
        return (vals.astype(np.int64) + 1).astype(np.uint32)

    def list_docids(self, i: int) -> np.ndarray:
        p0, p1 = self.list_blocks(i)
        return np.concatenate([self.block_docs(b, i) for b in range(p0, p1)])

    def list_freqs(self, i: int) -> np.ndarray:
        p0, p1 = self.list_blocks(i)
        return np.concatenate([self.block_freqs(b, i) for b in range(p0, p1)])

    def ensure_docs_end(self) -> None:
        if self.docs_end is not None:
            return
        dec = _codec(self.codec)[1]
        docs_end = np.zeros(self.num_blocks, dtype=np.uint64)
        for i in range(self.num_lists):
            p0, p1 = self.list_blocks(i)
            for b in range(p0, p1):
                size, base = self._block_geom(b, i)
                sum_v = int(self.block_max[b]) - base - (size - 1)
                _, end = dec(self.arena, self.block_start(b), size, sum_v)
                docs_end[b] = end
        self.docs_end = docs_end


class BlockTermDecoder:
    """TermDecoder-compatible reader (host decode, cached); ``device`` is
    where the serving engines put what it decodes."""

    def __init__(self, index: BlockIndex, device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self._doc_cache = {}
        self._freq_cache = {}
        self._lazy_cache = None

    @property
    def lazy_cache(self):
        """Skip-aware block decoder — gives the block-codec indexes the
        same WAND/maxscore/lazy-AND machinery as the DINT index."""
        if self._lazy_cache is None:
            from ..query.lazy_decode import ZooBlockCache

            self._lazy_cache = ZooBlockCache(self.index)
        return self._lazy_cache

    def decode_docids(self, terms):
        for t in dict.fromkeys(terms):
            if t not in self._doc_cache:
                self._doc_cache[t] = self.index.list_docids(int(t))
        return {t: self._doc_cache[t] for t in dict.fromkeys(terms)}

    def decode_freqs(self, terms):
        for t in dict.fromkeys(terms):
            if t not in self._freq_cache:
                self._freq_cache[t] = self.index.list_freqs(int(t))
        return {t: self._freq_cache[t] for t in dict.fromkeys(terms)}


def build_block_index(basename: str, codec: str) -> BlockIndex:
    enc = _codec(codec)[0]
    view = open_freq_collection(basename)
    tools_common.log(f"encoding posting lists (block codec = {codec})...")
    list_n: List[int] = []
    block_ptr = [0]
    block_max: List[int] = []
    docs_end: List[int] = []
    block_end: List[int] = []
    parts: List[bytes] = []
    pos = 0
    for docs, freqs in view:
        n = int(docs.shape[0])
        list_n.append(n)
        dgaps = gap_mod.docs_to_gaps(docs)
        fgaps = gap_mod.freqs_to_gaps(freqs)
        base = 0
        for p in range(0, n, BLOCK_SIZE):
            size = min(BLOCK_SIZE, n - p)
            last_doc = int(docs[p + size - 1])
            block_max.append(last_doc)
            db = enc(dgaps[p : p + size], last_doc - base - (size - 1))
            fb = enc(fgaps[p : p + size], blocks_mod.UNKNOWN)
            parts.append(db)
            pos += len(db)
            docs_end.append(pos)
            parts.append(fb)
            pos += len(fb)
            block_end.append(pos)
            base = last_doc + 1
        block_ptr.append(len(block_max))
    return BlockIndex(
        codec,
        view.num_docs,
        np.asarray(list_n, np.uint32),
        np.asarray(block_ptr, np.uint64),
        np.asarray(block_max, np.uint32),
        np.asarray(docs_end, np.uint64),
        np.asarray(block_end, np.uint64),
        np.frombuffer(b"".join(parts), dtype=np.uint8),
    )


def verify_block_index(index: BlockIndex, basename: str) -> None:
    view = open_freq_collection(basename)
    for i, (docs, freqs) in enumerate(view):
        if not np.array_equal(index.list_docids(i), docs):
            raise SystemExit(f"docid mismatch in list {i} ({index.codec})")
        if not np.array_equal(index.list_freqs(i), freqs):
            raise SystemExit(f"freq mismatch in list {i} ({index.codec})")


def get_blocks(index: BlockIndex, i: int):
    """Extract raw per-block data for transformation
    (block_posting_list.hpp:55-82 / dict_posting_list.hpp:242-277
    get_blocks capability): list of dicts with the block's logical
    position, max docid, size and raw docs/freqs payload bytes."""
    index.ensure_docs_end()
    p0, p1 = index.list_blocks(i)
    out = []
    for b in range(p0, p1):
        size, _ = index._block_geom(b, i)
        s = index.block_start(b)
        de = int(index.docs_end[b])
        e = int(index.block_end[b])
        out.append(
            {
                "index": b - p0,
                "max": int(index.block_max[b]),
                "size": size,
                "docs_bytes": bytes(index.arena[s:de]),
                "freqs_bytes": bytes(index.arena[de:e]),
            }
        )
    return out


def write_blocks(index: BlockIndex, per_list_blocks) -> BlockIndex:
    """Rebuild an index from (possibly reordered/transformed) block data
    (block_posting_list.hpp write_blocks / dict_posting_list.hpp:58-86):
    blocks may be supplied in any order; they are laid out by their
    logical `index` field, and the first block must remain first."""
    list_n = []
    block_ptr = [0]
    block_max = []
    docs_end = []
    block_end = []
    parts = []
    pos = 0
    for blocks in per_list_blocks:
        blocks = sorted(blocks, key=lambda blk: blk["index"])
        assert blocks[0]["index"] == 0, "first block must remain first"
        n = sum(blk["size"] for blk in blocks)
        list_n.append(n)
        for blk in blocks:
            block_max.append(blk["max"])
            parts.append(blk["docs_bytes"])
            pos += len(blk["docs_bytes"])
            docs_end.append(pos)
            parts.append(blk["freqs_bytes"])
            pos += len(blk["freqs_bytes"])
            block_end.append(pos)
        block_ptr.append(len(block_max))
    return BlockIndex(
        index.codec,
        index.num_docs,
        np.asarray(list_n, np.uint32),
        np.asarray(block_ptr, np.uint64),
        np.asarray(block_max, np.uint32),
        np.asarray(docs_end, np.uint64),
        np.asarray(block_end, np.uint64),
        np.frombuffer(b"".join(parts), dtype=np.uint8),
    )
