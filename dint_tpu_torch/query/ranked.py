"""Ranked retrieval: BM25 scoring, wand_data, the exhaustive top-k oracle.

The port's copy of the host part of ``dint_tpu/query/ranked.py``.  BM25
constants and formulas match bm25.hpp:7-25 exactly (k1=1.2, b=0.5, idf
floored at 1e-6, query weight scaled by (1+k1)); wand_data matches
wand_data.hpp:17-53 (lengths normalized by the average, per-term max
doc_term_weight), plus the per-256-block max weights.

`ranked_or` is the exhaustive union scorer — the oracle the reference's
own tests compare WAND/maxscore against (test_ranked_queries.cpp:43-55).
`wand` implements the reference's WAND pivoting (queries.hpp:190-307)
and `maxscore` the essential/non-essential list split
(queries.hpp:459-573), both over the skip-aware lazy block decoder
(query/lazy_decode.py) so only the blocks the skips land in are decoded;
`ranked_and` scores the lazy AND set.  Per-query block and posting
counters live on the decoder's lazy cache.  All host numpy: the batched
analogue on the device (block-max pruning before the sort-merge top-k)
is query/bmw_device.py with query/device_serve.py.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from ..io.collection import open_freq_collection, read_sizes_file

K1 = 1.2
B = 0.5
EPS_SCORE = 1e-6


def doc_term_weight(freq: np.ndarray, norm_len: np.ndarray) -> np.ndarray:
    f = freq.astype(np.float32)
    return f / (f + np.float32(K1) * (1.0 - B + B * norm_len.astype(np.float32)))


def query_term_weight(qf: int, df: int, num_docs: int) -> float:
    idf = np.log((float(num_docs) - df + 0.5) / (df + 0.5))
    return float(qf) * max(EPS_SCORE, float(idf)) * (1.0 + K1)


@dataclass
class WandData:
    """wand_data sidecar (wand_data.hpp) + per-block extension: per-doc
    normalized lengths, one max term weight per term, and a per-256-block
    max doc_term_weight (``block_maxw`` flat over blocks in list order,
    ``block_ptr`` the per-term offsets).  Its ``.npz`` file is the
    reference package's."""

    norm_lens: np.ndarray  # (num_docs,) f32, lengths / avg length
    max_term_weight: np.ndarray  # (num_terms,) f32
    block_maxw: Optional[np.ndarray] = None  # (NB,) f32 per-block max dtw
    block_ptr: Optional[np.ndarray] = None  # (num_terms+1,) i64

    def save(self, path: str) -> None:
        extra = {}
        if self.block_maxw is not None:
            extra = {"block_maxw": self.block_maxw, "block_ptr": self.block_ptr}
        np.savez(
            path,
            norm_lens=self.norm_lens,
            max_term_weight=self.max_term_weight,
            **extra,
        )

    @classmethod
    def load(cls, path: str) -> "WandData":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(
            z["norm_lens"],
            z["max_term_weight"],
            z["block_maxw"] if "block_maxw" in z else None,
            z["block_ptr"] if "block_ptr" in z else None,
        )


def build_wand_data(basename: str, block_max: bool = True) -> WandData:
    """create_wand_data equivalent (src/create_wand_data.cpp); also
    computes the per-256-block max weights unless ``block_max=False``."""
    sizes = read_sizes_file(basename).astype(np.float64)
    norm = (sizes / sizes.mean()).astype(np.float32)
    view = open_freq_collection(basename)
    maxw = np.zeros(len(view), dtype=np.float32)
    block_ptr = np.zeros(len(view) + 1, dtype=np.int64)
    bmw_parts: List[np.ndarray] = []
    for i, (docs, freqs) in enumerate(view):
        w = doc_term_weight(freqs, norm[docs.astype(np.int64)])
        maxw[i] = w.max() if w.shape[0] else 0.0
        if block_max:
            nb = -(-w.shape[0] // BLOCK_SIZE)
            block_ptr[i + 1] = block_ptr[i] + nb
            if nb:
                pad = np.zeros(nb * BLOCK_SIZE, dtype=np.float32)
                pad[: w.shape[0]] = w
                bmw_parts.append(pad.reshape(nb, BLOCK_SIZE).max(axis=1))
    if block_max:
        flat = (
            np.concatenate(bmw_parts)
            if bmw_parts
            else np.zeros(0, np.float32)
        )
        return WandData(norm, maxw, flat.astype(np.float32), block_ptr)
    return WandData(norm, maxw)


def query_weights_from(
    df: np.ndarray, num_docs: int, terms: Sequence[int]
) -> List[Tuple[int, float]]:
    """(term, q_weight) pairs from explicit global statistics;
    duplicate query terms raise qf (wand_query ctor semantics,
    queries.hpp:209-222)."""
    qf: Dict[int, int] = {}
    for t in terms:
        qf[int(t)] = qf.get(int(t), 0) + 1
    out = []
    for t, f in sorted(qf.items()):
        out.append((t, query_term_weight(f, int(df[t]), num_docs)))
    return out


def _query_weights(index, terms: Sequence[int]) -> List[Tuple[int, float]]:
    return query_weights_from(index.list_n, index.num_docs, terms)


def ranked_or(index, decoder, wdata: WandData, terms: Sequence[int],
              k: int = 10) -> np.ndarray:
    """Exhaustive union scoring; returns top-k scores descending."""
    weighted = _query_weights(index, terms)
    if not weighted:
        return np.zeros(0, dtype=np.float32)
    tlist = [t for t, _ in weighted]
    docs = decoder.decode_docids(tlist)
    freqs = decoder.decode_freqs(tlist)
    all_docs = np.concatenate([docs[t] for t in tlist])
    all_scores = np.concatenate(
        [
            np.float32(qw)
            * doc_term_weight(freqs[t], wdata.norm_lens[docs[t].astype(np.int64)])
            for t, qw in weighted
        ]
    )
    if all_docs.shape[0] == 0:  # every query term has an empty list
        return np.zeros(0, dtype=np.float32)
    order = np.argsort(all_docs, kind="stable")
    d = all_docs[order]
    s = all_scores[order]
    boundary = np.empty(d.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = d[1:] != d[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(s, starts)
    top = np.sort(sums)[::-1][:k]
    return top.astype(np.float32)


class TopKQueue:
    """Min-heap of the k best scores (topk_queue, queries.hpp:150-188)."""

    __slots__ = ("k", "q")

    def __init__(self, k: int):
        self.k = k
        self.q: List[float] = []

    def would_enter(self, score: float) -> bool:
        return len(self.q) < self.k or score > self.q[0]

    def insert(self, score: float) -> bool:
        if len(self.q) < self.k:
            heapq.heappush(self.q, score)
            return True
        if score > self.q[0]:
            heapq.heapreplace(self.q, score)
            return True
        return False

    def topk(self) -> np.ndarray:
        return np.sort(np.asarray(self.q, dtype=np.float32))[::-1]


def _lazy_cursors(index, decoder, terms):
    """Per-term skipping cursors from the decoder's lazy cache.

    Caches expose ``make_cursor`` (block caches return the block-max
    leapfrog cursor, EF caches return pointer-skipping enumerator
    cursors); all cursors share the docid/freq/next/next_geq protocol."""
    cache = decoder.lazy_cache
    if hasattr(cache, "make_cursor"):
        return cache, [cache.make_cursor(t) for t, _ in terms]
    from .lazy_decode import Cursor

    return cache, [Cursor(cache, t) for t, _ in terms]


def wand(
    index,
    decoder,
    wdata: WandData,
    terms: Sequence[int],
    k: int = 10,
) -> np.ndarray:
    """WAND pivoting (queries.hpp:190-307): prefix-sum the per-list
    max weights in docid order to find the pivot; score only pivot
    candidates; `next_geq` the farthest list otherwise.  Decodes only
    the blocks the skips land in (lazy_decode counters prove it).

    Decoders without a lazy block engine (EF / block-codec indexes)
    fall back to the exhaustive scorer — identical top-k, no pruning."""
    if not hasattr(decoder, "lazy_cache"):
        return ranked_or(index, decoder, wdata, terms, k)
    weighted = _query_weights(index, terms)
    if not weighted:
        return np.zeros(0, dtype=np.float32)
    cache, cursors = _lazy_cursors(index, decoder, weighted)
    num_docs = index.num_docs
    enums = []  # [cursor, q_weight, max_weight]
    for (t, qw), cur in zip(weighted, cursors):
        enums.append((cur, np.float32(qw), np.float32(qw * wdata.max_term_weight[t])))
    ordered = sorted(enums, key=lambda e: e[0].docid())
    topk = TopKQueue(k)
    norm_lens = wdata.norm_lens

    while True:
        # find pivot (queries.hpp:241-253)
        upper_bound = np.float32(0.0)
        found_pivot = False
        pivot = 0
        for pivot in range(len(ordered)):
            if ordered[pivot][0].docid() == num_docs:
                break
            upper_bound = np.float32(upper_bound + ordered[pivot][2])
            if topk.would_enter(float(upper_bound)):
                found_pivot = True
                break
        if not found_pivot:
            break
        pivot_id = ordered[pivot][0].docid()
        if pivot_id == ordered[0][0].docid():
            score = np.float32(0.0)
            nl = norm_lens[pivot_id]
            for cur, qw, _ in ordered:
                if cur.docid() != pivot_id:
                    break
                f = np.float32(cur.freq())
                score = np.float32(
                    score + qw * (f / (f + np.float32(K1) * (1.0 - B + B * nl)))
                )
                cache.postings_scored += 1
                cur.next()
            topk.insert(float(score))
            ordered.sort(key=lambda e: e[0].docid())
        else:
            next_list = pivot
            while ordered[next_list][0].docid() == pivot_id:
                next_list -= 1
            ordered[next_list][0].next_geq(pivot_id)
            for i in range(next_list + 1, len(ordered)):
                if ordered[i][0].docid() < ordered[i - 1][0].docid():
                    ordered[i], ordered[i - 1] = ordered[i - 1], ordered[i]
                else:
                    break
    return topk.topk()


def maxscore(
    index,
    decoder,
    wdata: WandData,
    terms: Sequence[int],
    k: int = 10,
) -> np.ndarray:
    """maxscore essential/non-essential split (queries.hpp:459-573):
    lists sorted by max weight; lists whose prefix upper bound cannot
    enter the top-k become non-essential and are only probed by
    next_geq during score completion.  Decoders without a lazy block
    engine fall back to the exhaustive scorer."""
    if not hasattr(decoder, "lazy_cache"):
        return ranked_or(index, decoder, wdata, terms, k)
    weighted = _query_weights(index, terms)
    if not weighted:
        return np.zeros(0, dtype=np.float32)
    cache, cursors = _lazy_cursors(index, decoder, weighted)
    num_docs = index.num_docs
    enums = []
    for (t, qw), cur in zip(weighted, cursors):
        enums.append((cur, np.float32(qw), np.float32(qw * wdata.max_term_weight[t])))
    ordered = sorted(enums, key=lambda e: float(e[2]))  # increasing maxscore
    upper_bounds = np.cumsum([float(e[2]) for e in ordered]).astype(np.float32)
    topk = TopKQueue(k)
    norm_lens = wdata.norm_lens
    non_essential = 0
    cur_doc = min(e[0].docid() for e in enums)

    while non_essential < len(ordered) and cur_doc < num_docs:
        score = np.float32(0.0)
        nl = norm_lens[cur_doc] if cur_doc < num_docs else np.float32(0)
        next_doc = num_docs
        for i in range(non_essential, len(ordered)):
            cur, qw, _ = ordered[i]
            if cur.docid() == cur_doc:
                f = np.float32(cur.freq())
                score = np.float32(
                    score + qw * (f / (f + np.float32(K1) * (1.0 - B + B * nl)))
                )
                cache.postings_scored += 1
                cur.next()
            if cur.docid() < next_doc:
                next_doc = cur.docid()
        # try to complete evaluation with non-essential lists
        for i in range(non_essential - 1, -1, -1):
            if not topk.would_enter(float(score + upper_bounds[i])):
                break
            cur, qw, _ = ordered[i]
            cur.next_geq(cur_doc)
            if cur.docid() == cur_doc:
                f = np.float32(cur.freq())
                score = np.float32(
                    score + qw * (f / (f + np.float32(K1) * (1.0 - B + B * nl)))
                )
                cache.postings_scored += 1
        if topk.insert(float(score)):
            while non_essential < len(ordered) and not topk.would_enter(
                float(upper_bounds[non_essential])
            ):
                non_essential += 1
        cur_doc = next_doc
    return topk.topk()


def ranked_and(
    index,
    decoder,
    wdata: WandData,
    terms: Sequence[int],
    k: int = 10,
) -> np.ndarray:
    """ranked_and_query (queries.hpp:309-385): score docs in the AND
    set.  With a block-structured lazy cache the AND leapfrogs over
    block_max skip data and only matched blocks' freqs decode
    (dict_posting_list.hpp:126-147, :164-169 semantics)."""
    from .boolean import and_query, and_query_lazy, matched_freqs_lazy

    weighted = _query_weights(index, terms)
    if not weighted:
        return np.zeros(0, dtype=np.float32)
    tlist = [t for t, _ in weighted]

    cache = getattr(decoder, "lazy_cache", None)
    if cache is not None and hasattr(cache, "docs_blocks_batch"):
        cand = and_query_lazy(cache, tlist)
        if cand.shape[0] == 0:
            return np.zeros(0, dtype=np.float32)
        mf = matched_freqs_lazy(cache, tlist, cand)
        total = np.zeros(cand.shape[0], dtype=np.float32)
        nl = wdata.norm_lens[cand.astype(np.int64)]
        for t, qw in weighted:
            total += np.float32(qw) * doc_term_weight(mf[t], nl)
        cache.postings_scored += cand.shape[0] * len(weighted)
        return np.sort(total)[::-1][:k].astype(np.float32)

    docs = decoder.decode_docids(tlist)
    freqs = decoder.decode_freqs(tlist)
    cand = and_query(docs, tlist)
    if cand.shape[0] == 0:
        return np.zeros(0, dtype=np.float32)
    total = np.zeros(cand.shape[0], dtype=np.float32)
    nl = wdata.norm_lens[cand.astype(np.int64)]
    for t, qw in weighted:
        pos = np.searchsorted(docs[t], cand)
        total += np.float32(qw) * doc_term_weight(freqs[t][pos], nl)
    return np.sort(total)[::-1][:k].astype(np.float32)
