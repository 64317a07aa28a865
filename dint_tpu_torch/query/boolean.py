"""Boolean query processing — and_query / or_query equivalents.

The port's copy of the host part of ``dint_tpu/query/boolean.py``.
Reference semantics (queries.hpp:34-130): AND deduplicates terms, sorts
lists by size and keeps the candidates found in every larger list; OR is
the sorted union.  Result docID sets are exact.  The skip-aware
``*_lazy`` forms decode, through the lazy block cache
(query/lazy_decode.py), only the blocks the candidates land in.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_query_log(path: str) -> List[List[int]]:
    """read_query format (queries.hpp:15-27): whitespace term ids per line."""
    out: List[List[int]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                out.append([int(t) for t in toks])
    return out


def dedup_terms(terms: Sequence[int]) -> List[int]:
    """remove_duplicate_terms (queries.hpp:29-32): sort + unique."""
    return sorted(set(int(t) for t in terms))


def and_query(decoded: Dict[int, np.ndarray], terms: Sequence[int]) -> np.ndarray:
    """Exact AND result docIDs."""
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    lists = sorted((decoded[t] for t in terms), key=len)
    cand = lists[0]
    for arr in lists[1:]:
        if cand.shape[0] == 0:
            break
        pos = np.searchsorted(arr, cand)
        ok = pos < arr.shape[0]
        ok[ok] = arr[pos[ok]] == cand[ok]
        cand = cand[ok]
    return cand


def or_query(decoded: Dict[int, np.ndarray], terms: Sequence[int]) -> np.ndarray:
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    return np.unique(np.concatenate([decoded[t] for t in terms]))


def and_query_lazy(cache, terms: Sequence[int]) -> np.ndarray:
    """Skip-aware AND: decode only the blocks candidates land in.

    The smallest list leads (decoded fully, like the first list of the
    reference's leapfrog, queries.hpp:51-59); every larger list is probed
    block-wise — candidates map to blocks via the stored block_max skip
    data, only those blocks decode (dict_posting_list.hpp:126-147), and
    membership resolves with an in-block searchsorted.  An AND of a
    100-posting and a 10M-posting term decodes O(100) blocks of the
    larger list (cache.docs_blocks_decoded proves it)."""
    idx = cache.index
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    order = sorted(terms, key=lambda t: int(idx.list_n[t]))
    t0 = order[0]
    p0, p1 = idx.list_blocks(t0)
    cache.docs_blocks_batch([(t0, b) for b in range(p0, p1)])
    if p0 == p1:
        return np.zeros(0, dtype=np.uint32)
    cand = np.concatenate([cache.docs_block(t0, b) for b in range(p0, p1)])
    for t in order[1:]:
        if cand.shape[0] == 0:
            break
        q0, q1 = idx.list_blocks(t)
        maxs = idx.block_max[q0:q1]
        bi = np.searchsorted(maxs, cand, side="left")
        keep = bi < (q1 - q0)
        cand, bi = cand[keep], bi[keep]
        if cand.shape[0] == 0:
            break
        blocks = np.unique(bi)
        cache.docs_blocks_batch([(t, q0 + int(b)) for b in blocks])
        ok = np.zeros(cand.shape[0], dtype=bool)
        for b in blocks:
            m = bi == b
            blk = cache.docs_block(t, q0 + int(b))
            pos = np.searchsorted(blk, cand[m], side="left")
            good = pos < blk.shape[0]
            good[good] = blk[pos[good]] == cand[m][good]
            ok[m] = good
        cand = cand[ok]
    return cand


def or_query_lazy(cache, terms: Sequence[int]) -> np.ndarray:
    """Union with decode included (every block of every term is needed;
    the lazy engine batch-decodes them in one vectorized pass)."""
    idx = cache.index
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    pairs = []
    for t in terms:
        p0, p1 = idx.list_blocks(t)
        pairs.extend((t, b) for b in range(p0, p1))
    cache.docs_blocks_batch(pairs)
    parts = [cache.docs_block(t, b) for t, b in pairs]
    if not parts:
        return np.zeros(0, dtype=np.uint32)
    return np.unique(np.concatenate(parts))


def matched_freqs_lazy(cache, terms: Sequence[int], matches: np.ndarray):
    """Touch the freqs of every matched posting, decoding only the freq
    blocks that contain matches (the *_freq variants' contract,
    queries.hpp:66-76 + lazy freq semantics dict_posting_list.hpp:164-169)."""
    idx = cache.index
    out = {}
    for t in dedup_terms(terms):
        q0, q1 = idx.list_blocks(t)
        maxs = idx.block_max[q0:q1]
        bi = np.searchsorted(maxs, matches, side="left")
        blocks = np.unique(bi[bi < (q1 - q0)])
        cache.freqs_blocks_batch([(t, q0 + int(b)) for b in blocks])
        vals = np.zeros(matches.shape[0], dtype=np.uint32)
        for b in blocks:
            m = bi == b
            blk_d = cache.docs_block(t, q0 + int(b))
            blk_f = cache.freqs_block(t, q0 + int(b))
            pos = np.searchsorted(blk_d, matches[m], side="left")
            good = pos < blk_d.shape[0]
            good[good] = blk_d[pos[good]] == matches[m][good]
            mm = np.flatnonzero(m)[good]
            vals[mm] = blk_f[pos[good]]
        out[t] = vals
    return out


def run_boolean_batch(
    decoder,
    queries: Sequence[Sequence[int]],
    op: str,
    with_freqs: bool = False,
) -> Tuple[List[np.ndarray], List[float]]:
    """Execute a batch; returns (result docid arrays, per-query seconds).

    All terms decode up-front in one pass of the decoder (untimed warm
    cache, like the reference's warmup at queries.cpp:74-83); timings
    cover the per-query merge work.
    """
    all_terms = sorted({int(t) for q in queries for t in q})
    decoded = decoder.decode_docids(all_terms)
    freqs = decoder.decode_freqs(all_terms) if with_freqs else None
    results: List[np.ndarray] = []
    timings: List[float] = []
    fn = and_query if op == "and" else or_query
    for q in queries:
        t0 = time.perf_counter()
        res = fn(decoded, q)
        if with_freqs and res.shape[0]:
            # *_freq variants materialize matched freqs (queries.hpp:66-76)
            for t in dedup_terms(q):
                d = decoded[t]
                pos = np.searchsorted(d, res)
                pos = np.clip(pos, 0, max(d.shape[0] - 1, 0))
                _ = freqs[t][pos]
        timings.append(time.perf_counter() - t0)
        results.append(res)
    return results, timings
