"""Block-Max WAND pruning — the batched analogue of pivoting (host copy).

The port's copy of ``dint_tpu/query/bmw.py``: numpy only; the batched
survival test on the card is ``query/bmw_device.py``.

The reference's WAND (queries.hpp:190-307) prunes with one max weight
per list; its skips are sequential pointer jumps.  The batched
formulation works at block granularity and is *set-at-a-time*: given a
valid lower bound tau on the final k-th score, a whole 256-int block b
of term t can be discarded when no doc inside it could reach tau even
with every other term contributing its best overlapping-block weight:

    test(b, t) = ub(b, t) + sum_{t' != t} max{ ub(c, t') :
                 c overlaps b's docid range }        < tau

where ub(b, t) = q_weight(t) * block_maxw(t, b) (the per-block max
doc_term_weight sidecar, ranked.WandData.block_maxw).

EXACTNESS.  For any doc d in block b, its true score S(d) and its
interval upper bound U(d) = sum_t ub(block_t(d), t) satisfy
S(d) <= U(d) <= test(b, t).  tau is a LOWER bound on the true k-th
score (it is the k-th best of real partial scores).  Hence:
* every doc of the true top-k has U(d) >= S(d) >= kth >= tau, so every
  block containing it survives — its computed score is complete;
* a doc in any discarded block has S(d) <= U(d) < tau <= kth, so its
  (possibly partial) computed score stays strictly below the true
  top-k scores and cannot displace them.
The surviving-block postings therefore produce exactly ranked_or's
top-k through the ordinary sort-merge top-k
(device_batch.ranked_union_topk).

tau comes from scoring a handful of real blocks: the highest
single-block upper bounds among all query terms (their single-term
scores are partial scores of real docs, hence valid lower bounds).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from . import ranked as ranked_mod
from .device_batch import PAD_DOC


class _RangeMax:
    """O(1) range-max over a f32 array via a log-level sparse table."""

    def __init__(self, vals: np.ndarray):
        self.levels = [np.asarray(vals, np.float32)]
        n = vals.shape[0]
        k = 1
        while 2 * k <= n:
            prev = self.levels[-1]
            self.levels.append(np.maximum(prev[: n - 2 * k + 1], prev[k : n - k + 1]))
            k *= 2

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """max(vals[lo:hi]) elementwise; lo < hi (i32/i64 arrays)."""
        length = hi - lo
        out = np.zeros(lo.shape[0], np.float32)
        nz = length > 0
        if not nz.any():
            return out
        lvl = np.zeros(lo.shape[0], np.int64)
        lvl[nz] = np.floor(np.log2(length[nz])).astype(np.int64)
        lvl = np.minimum(lvl, len(self.levels) - 1)
        for l in np.unique(lvl[nz]):
            m = nz & (lvl == l)
            tab = self.levels[int(l)]
            k = 1 << int(l)
            a = tab[lo[m]]
            b = tab[np.maximum(hi[m] - k, lo[m])]
            out[m] = np.maximum(a, b)
        return out


def _term_geom(index, wdata, t: int, qw: float):
    """(lo docids, hi docids, ub) per block of term t."""
    p0, p1 = index.list_blocks(t)
    hi = index.block_max[p0:p1].astype(np.int64)
    if hi.shape[0] == 0:  # empty posting list: no blocks, no events
        return hi, hi, np.zeros(0, np.float32)
    lo = np.concatenate([[0], hi[:-1] + 1])
    w0 = int(wdata.block_ptr[t])
    ub = np.float32(qw) * wdata.block_maxw[w0 : w0 + (p1 - p0)]
    return lo, hi, ub.astype(np.float32)


def estimate_tau(cache, index, wdata, weighted, k: int, probe_blocks: int = 4):
    """Valid lower bound on the k-th best total score: decode the
    highest-upper-bound blocks across terms and take the k-th best
    REAL single-term partial score found there."""
    cand: List[Tuple[float, int, int]] = []  # (ub, term, rel block)
    for t, qw in weighted:
        lo, hi, ub = _term_geom(index, wdata, t, qw)
        for rb in np.argsort(ub)[::-1][:probe_blocks]:
            cand.append((float(ub[rb]), t, int(rb)))
    cand.sort(reverse=True)
    doc_parts: List[np.ndarray] = []
    score_parts: List[np.ndarray] = []
    qw_of = dict(weighted)
    for _, t, rb in cand[: 2 * probe_blocks]:
        p0, _ = index.list_blocks(t)
        d = cache.docs_block(t, p0 + rb)
        f = cache.freqs_block(t, p0 + rb)
        w = ranked_mod.doc_term_weight(f, wdata.norm_lens[d.astype(np.int64)])
        doc_parts.append(d.astype(np.int64))
        score_parts.append(np.float32(qw_of[t]) * w)
    if not doc_parts:
        return 0.0
    # aggregate partials per DISTINCT doc (the k-th-best lower bound
    # needs k distinct docs, each with an achievable partial score)
    d = np.concatenate(doc_parts)
    s = np.concatenate(score_parts).astype(np.float32)
    order = np.argsort(d, kind="stable")
    d, s = d[order], s[order]
    boundary = np.empty(d.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = d[1:] != d[:-1]
    per_doc = np.add.reduceat(s, np.flatnonzero(boundary))
    if per_doc.shape[0] < k:
        return 0.0
    return float(np.sort(per_doc)[::-1][k - 1])


class _PointBound:
    """Exact per-posting upper bound of one term's contribution over a
    docid interval: max weight among its (surviving) postings inside
    [lo, hi], 0 where it has none.  Built from decoded survivor blocks
    of cheap terms in the refinement pass — this is what gives the
    batch pruner WAND's doc-level resolution (a block of a huge term
    with no rare-term posting inside scores at most its own ub)."""

    def __init__(self, docids: np.ndarray, weights: np.ndarray):
        self.docids = docids.astype(np.int64)
        self.table = _RangeMax(weights.astype(np.float32))

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        i0 = np.searchsorted(self.docids, lo, side="left")
        i1 = np.searchsorted(self.docids, hi, side="right")
        return self.table.query(i0, np.maximum(i1, i0))


REFINE_POSTINGS_LIMIT = 1 << 16  # decode-for-refinement budget per term


def _block_sizes(index, t: int, nb: int) -> np.ndarray:
    n = int(index.list_n[t])
    sizes = np.full(nb, BLOCK_SIZE, np.int64)
    if nb:
        sizes[-1] = n - (nb - 1) * BLOCK_SIZE
    return sizes


def prune_blocks(
    cache,
    index,
    wdata,
    terms: Sequence[int],
    k: int,
    _cache: Dict = None,
) -> Tuple[Dict[int, np.ndarray], float, Dict[str, int]]:
    """Per-term boolean mask of surviving blocks.

    Two passes: (1) block-interval bounds for every term; (2) terms
    whose survivors are cheap decode and replace their step-function
    bound with exact per-posting point bounds, killing every partner
    block that contains none of their postings (the batched analogue of
    WAND's next_geq jumps).  Returns ({term: keep mask}, tau, stats)."""
    weighted = ranked_mod._query_weights(index, terms)
    if wdata.block_maxw is None:
        raise ValueError("wand_data has no block-max sidecar")
    tau = estimate_tau(cache, index, wdata, weighted, k)
    # shave a few ulps: scores sum in f32 (rounding can land a hair
    # above the f64 bound sums), keep the survival test conservative
    tau *= 1.0 - 1e-6
    # geometry + range-max tables are reusable across queries when the
    # query weight matches (it does unless the term repeats in a query):
    # batch callers pass a shared dict keyed by (term, qw)
    if _cache is None:
        _cache = {}
    geoms, tables = {}, {}
    for t, qw in weighted:
        key = (t, float(qw))
        if key not in _cache:
            g = _term_geom(index, wdata, t, qw)
            _cache[key] = (g, _RangeMax(g[2]))
        geoms[t], tables[t] = _cache[key]

    def pass_tests(bounds) -> Dict[int, np.ndarray]:
        out = {}
        for t, qw in weighted:
            lo, hi, ub = geoms[t]
            test = ub.astype(np.float64).copy()
            for t2, _ in weighted:
                if t2 == t:
                    continue
                pb = bounds.get(t2)
                if pb is not None:
                    test += pb.query(lo, hi)
                else:
                    lo2, hi2, _ = geoms[t2]
                    i0 = np.searchsorted(hi2, lo, side="left")
                    i1 = np.searchsorted(lo2, hi, side="right")
                    test += tables[t2].query(
                        i0.astype(np.int64),
                        np.maximum(i1, i0).astype(np.int64),
                    )
            out[t] = test >= tau
        return out

    keep = pass_tests({})

    # refinement: exact point bounds for terms with cheap survivors
    point: Dict[int, _PointBound] = {}
    if len(weighted) > 1 and tau > 0.0:
        for t, qw in weighted:
            nb = keep[t].shape[0]
            kept_sz = int(_block_sizes(index, t, nb)[keep[t]].sum())
            if 0 < kept_sz <= REFINE_POSTINGS_LIMIT:
                p0, _ = index.list_blocks(t)
                pairs = [(t, p0 + int(rb)) for rb in np.flatnonzero(keep[t])]
                cache.docs_blocks_batch(pairs)
                cache.freqs_blocks_batch(pairs)
                dparts, wparts = [], []
                for _, b in pairs:
                    d = cache.docs_block(t, b)
                    f = cache.freqs_block(t, b)
                    dparts.append(d)
                    wparts.append(
                        np.float32(qw)
                        * ranked_mod.doc_term_weight(
                            f, wdata.norm_lens[d.astype(np.int64)]
                        )
                    )
                point[t] = _PointBound(
                    np.concatenate(dparts), np.concatenate(wparts)
                )
        if point:
            refined = pass_tests(point)
            for t in refined:
                keep[t] &= refined[t]

    stats = {"postings_total": 0, "postings_kept": 0, "blocks_total": 0,
             "blocks_kept": 0}
    for t, _ in weighted:
        m = keep[t]
        sizes = _block_sizes(index, t, m.shape[0])
        stats["postings_total"] += int(index.list_n[t])
        stats["postings_kept"] += int(sizes[m].sum())
        stats["blocks_total"] += m.shape[0]
        stats["blocks_kept"] += int(m.sum())
    return keep, tau, stats


def build_pruned_rows(
    cache,
    index,
    wdata,
    queries: Sequence[Sequence[int]],
    k: int,
) -> Tuple[List[np.ndarray], List[np.ndarray], Dict[str, int]]:
    """Per-query (docids i32, partial scores f32) rows containing ONLY
    surviving-block postings — drop-in replacement for
    device_batch.build_ranked_rows with block-max pruning applied.
    Decode happens once per surviving block (batched, lazy cache)."""
    # same guard as device_batch._check_docid_range: docids are sorted
    # as int32 with PAD_DOC as the padding sentinel, so a docid >=
    # 2^31-1 would wrap negative or collide with the pad
    if int(getattr(index, "num_docs", 0)) > int(PAD_DOC):
        raise ValueError(
            f"device batch engine requires docids < 2^31-1; index has "
            f"num_docs={index.num_docs}"
        )
    agg = {"postings_total": 0, "postings_kept": 0, "blocks_total": 0,
           "blocks_kept": 0}
    plans = []
    need: List[Tuple[int, int]] = []
    shared: Dict = {}
    for q in queries:
        weighted = ranked_mod._query_weights(index, q)
        if not weighted:
            plans.append((None, None))
            continue
        keep, tau, st = prune_blocks(cache, index, wdata, q, k, _cache=shared)
        for key in agg:
            agg[key] += st[key]
        plans.append((weighted, keep))
        for t, _ in weighted:
            p0, _ = index.list_blocks(t)
            need.extend((t, p0 + int(rb)) for rb in np.flatnonzero(keep[t]))
    need = list(dict.fromkeys(need))
    cache.docs_blocks_batch(need)
    cache.freqs_blocks_batch(need)
    drows: List[np.ndarray] = []
    srows: List[np.ndarray] = []
    for weighted, keep in plans:
        if weighted is None:
            drows.append(np.zeros(0, np.int32))
            srows.append(np.zeros(0, np.float32))
            continue
        dparts, sparts = [], []
        for t, qw in weighted:
            p0, _ = index.list_blocks(t)
            for rb in np.flatnonzero(keep[t]):
                d = cache.docs_block(t, p0 + int(rb))
                f = cache.freqs_block(t, p0 + int(rb))
                w = ranked_mod.doc_term_weight(
                    f, wdata.norm_lens[d.astype(np.int64)]
                )
                dparts.append(d.astype(np.int32))
                sparts.append(np.float32(qw) * w)
        drows.append(
            np.concatenate(dparts) if dparts else np.zeros(0, np.int32)
        )
        srows.append(
            np.concatenate(sparts).astype(np.float32)
            if sparts
            else np.zeros(0, np.float32)
        )
    return drows, srows, agg


def ranked_topk_pruned_host(
    cache, index, wdata, terms: Sequence[int], k: int = 10
) -> np.ndarray:
    """Host reference of the BMW engine: prune, decode survivors,
    exhaustive sort-merge on the survivors.  Exact top-k (see module
    docstring proof); used by tests to validate the pruning logic
    independent of the device kernel."""
    drows, srows, _ = build_pruned_rows(cache, index, wdata, [terms], k)
    d, s = drows[0], srows[0]
    if d.shape[0] == 0:
        return np.zeros(0, dtype=np.float32)
    order = np.argsort(d, kind="stable")
    d, s = d[order], s[order]
    boundary = np.empty(d.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = d[1:] != d[:-1]
    sums = np.add.reduceat(s, np.flatnonzero(boundary))
    return np.sort(sums)[::-1][:k].astype(np.float32)
