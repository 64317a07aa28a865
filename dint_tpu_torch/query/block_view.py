"""Load-time block serving view for EF-family indexes (host copy).

The reference serves its EF/PEF indexes by walking bit-level
enumerators over the mmap'd image (compact_elias_fano.hpp:138-417).
This framework's serving stance is "the wire format's job ends at
load" (the DINT ladder image, the zoo canonical image, the fused
device store): here the same idea gives the EF-family a native host
query path — every posting list bulk-decodes ONCE at load through the
native EF decoders (native/ef_decode.cpp) into a
raw-u32 block image with the standard SoA geometry (list_n /
block_ptr / block_max / docs_end / block_end / arena), which the
native cursor engine (native/query_host.cpp, codec "u32") then serves
with the same skip/scan machinery as every block index.  The
transcode cost is the honest cold start, reported by callers.

The EF enumerators themselves (codecs/ef_enum.py) remain the
skipping-access implementation and the parity oracle; this view is
the serving-throughput configuration.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..config import BLOCK_SIZE
from ..utils import gaps as gap_mod


@dataclass
class BlockView:
    """Duck-typed block index over pre-decoded postings (codec u32)."""

    codec: str
    num_docs: int
    list_n: np.ndarray
    block_ptr: np.ndarray
    block_max: np.ndarray
    block_end: np.ndarray
    docs_end: np.ndarray
    arena: np.ndarray
    cold_start_s: float = 0.0

    @property
    def num_lists(self) -> int:
        return int(self.list_n.shape[0])

    def list_blocks(self, i: int):
        return int(self.block_ptr[i]), int(self.block_ptr[i + 1])

    def ensure_docs_end(self) -> None:
        pass  # always materialized


def from_decoded(num_docs: int, doc_lists, freq_lists) -> BlockView:
    """Build the u32 block image from per-term (docids, freqs) arrays."""
    t0 = time.perf_counter()
    L = len(doc_lists)
    list_n = np.asarray([d.shape[0] for d in doc_lists], np.uint32)
    nb = -(-list_n.astype(np.int64) // BLOCK_SIZE)
    block_ptr = np.zeros(L + 1, np.uint64)
    np.cumsum(nb, out=block_ptr[1:].view(np.int64))
    NB = int(block_ptr[-1])
    block_max = np.zeros(NB, np.uint32)
    docs_end = np.zeros(NB, np.uint64)
    block_end = np.zeros(NB, np.uint64)
    chunks = []
    pos = 0
    b = 0
    for d, f in zip(doc_lists, freq_lists):
        n = int(d.shape[0])
        if not n:
            continue
        g = gap_mod.docs_to_gaps(d)
        fm1 = (np.asarray(f, np.uint32) - 1).astype("<u4")
        g = g.astype("<u4")
        for s in range(0, n, BLOCK_SIZE):
            e = min(s + BLOCK_SIZE, n)
            dpay = g[s:e].tobytes()
            fpay = fm1[s:e].tobytes()
            chunks.append(dpay)
            chunks.append(fpay)
            block_max[b] = d[e - 1]
            docs_end[b] = pos + len(dpay)
            pos += len(dpay) + len(fpay)
            block_end[b] = pos
            b += 1
    arena = np.frombuffer(b"".join(chunks), np.uint8)
    return BlockView(
        "u32", int(num_docs), list_n, block_ptr, block_max, block_end,
        docs_end, arena, cold_start_s=time.perf_counter() - t0,
    )


def from_ef_index(index, decoder=None) -> BlockView:
    """Transcode an EF-family index (index/freq_index.py) at load, with
    ``decoder``'s caches (a host decoder when none is given)."""
    from ..index.freq_index import EFTermDecoder

    t0 = time.perf_counter()
    dec = decoder or EFTermDecoder(index, device="cpu")
    terms = list(range(index.num_lists))
    docs = dec.decode_docids(terms)
    freqs = dec.decode_freqs(terms)
    view = from_decoded(
        index.num_docs, [docs[t] for t in terms], [freqs[t] for t in terms]
    )
    view.cold_start_s = time.perf_counter() - t0
    return view
