"""Serve a real built index over a ``torch.distributed`` group.

The port of ``dint_tpu/parallel/serve.py``.  Every function runs on
each rank of the group (``dist.run_ranks``) and returns the same numpy
result on every rank; where the reference takes a mesh, these take the
process group (``None``: the default one), and the rank count stands for
the mesh's device count.

* ``serve_ranked_doc_sharded``: a set of per-doc-range indexes, rank j
  decoding shard j only; per-rank sort-merge top-k, all_gather merge
  (``steps.doc_sharded_rows_topk_step``).
* ``serve_ranked_term_sharded``: a set of per-term-range indexes, rank j
  decoding shard j only; the rows travel to their doc-range owner with
  one all_to_all (``steps.term_sharded_rows_topk_step``).
* ``serve_boolean_doc_sharded``: per-rank ANDs over doc-range shards,
  concatenated in rank order.
* ``serve_ranked_sharded``: one index, its query rows built on every
  rank (``device_batch.build_ranked_rows``, or the Block-Max pruned rows
  of ``bmw_device``) and split by doc range, one range a rank.

Scoring uses the catalog's global document frequencies and the global
norm_lens, so every rank's partial scores are comparable.  Decoding runs
through ``TermDecoder`` on ``device`` (the card by default).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend import resolve_device
from ..query import device_batch

PAD_DOC = int(device_batch.PAD_DOC)


def shard_rows_by_doc(
    drows: Sequence[np.ndarray],
    srows: Sequence[np.ndarray],
    n_shards: int,
    num_docs: int,
    min_width: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split per-query (docid, score) rows into doc-range shards.

    Returns (d (S, Q, P) i32, s (S, Q, P) f32), PAD padded, where shard
    j owns docids in [j*ceil(num_docs/S), (j+1)*ceil(...)).
    ``min_width`` floors P (the top-k step needs k candidates per row).
    """
    S = n_shards
    span = -(-max(num_docs, 1) // S)
    Q = len(drows)
    per = [[None] * Q for _ in range(S)]
    for q in range(Q):
        d = np.asarray(drows[q], np.int64)
        s = np.asarray(srows[q], np.float32)
        shard_of = np.minimum(d // span, S - 1)
        for j in range(S):
            m = shard_of == j
            per[j][q] = (d[m].astype(np.int32), s[m])
    return pad_shard_rows(per, min_width)


def pad_shard_rows(
    per: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
    min_width: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-shard per-query (docid, score) pairs to (S, Q, P) with
    PAD_DOC / 0 fills; P = next pow2 of the widest row, floored at
    ``min_width`` (the top-k step needs k candidates per row)."""
    S = len(per)
    Q = len(per[0]) if S else 0
    width = max(
        [min_width]
        + [int(d.shape[0]) for qrows in per for d, _ in qrows]
    )
    P = 1 << max(int(np.ceil(np.log2(width))), 3)
    dd = np.full((S, Q, P), PAD_DOC, np.int32)
    ss = np.zeros((S, Q, P), np.float32)
    for j in range(S):
        for q in range(Q):
            d, s = per[j][q]
            dd[j, q, : d.shape[0]] = d
            ss[j, q, : s.shape[0]] = s
    return dd, ss


def _shard_of_rank(n_shards: int, group, what: str) -> int:
    """This rank's shard; the step serves exactly one shard a rank, so a
    shard count other than the rank count would drop shards."""
    world = dist.get_world_size(group)
    if n_shards != world:
        raise ValueError(
            f"shard count {n_shards} != ranks {world}: rebuild the shard "
            f"set or the group so each rank serves exactly one {what}")
    return dist.get_rank(group)


def _topk_numpy(v: torch.Tensor, ids: torch.Tensor):
    return v.cpu().numpy(), ids.cpu().numpy()


def serve_ranked_doc_sharded(
    group,
    sharded,  # parallel.build.DocShardedIndex
    norm_lens: np.ndarray,
    queries: Sequence[Sequence[int]],
    k: int = 10,
    device="cuda",
):
    """Exact ranked top-k over a set of per-doc-range indexes.

    The multi-host topology: each shard is a self-contained index over
    its doc range (``build.build_doc_sharded``), and rank j decodes shard
    j alone; scoring uses the catalog's global document frequencies and
    the global norm_lens, and the per-rank top-k merge through an
    all_gather.  Returns (scores (Q, k) desc, docids (Q, k) global ids)
    on every rank."""
    from ..query import ranked
    from ..query.term_decode import TermDecoder
    from . import steps

    j = _shard_of_rank(len(sharded.shards), group, "doc shard")
    dev = resolve_device(device)
    norm_lens = np.asarray(norm_lens, np.float32)
    dec = TermDecoder(sharded.shards[j], device=dev)
    lo = int(sharded.doc_lo[j])
    weighted = [ranked.query_weights_from(sharded.df, sharded.num_docs, q)
                for q in queries]
    terms = sorted({t for w in weighted for t, _ in w})
    docs = dec.decode_docids(terms)
    freqs = dec.decode_freqs(terms)
    qrows = []
    for w in weighted:
        ds, ss = [], []
        for t, qw in w:
            d = docs[t].astype(np.int64) + lo
            ds.append(d.astype(np.int32))
            ss.append(np.float32(qw)
                      * ranked.doc_term_weight(freqs[t], norm_lens[d]))
        d = np.concatenate(ds) if ds else np.zeros(0, np.int32)
        s = np.concatenate(ss) if ss else np.zeros(0, np.float32)
        qrows.append((d, s))
    dd, ss = pad_shard_rows([qrows], min_width=k)
    return _topk_numpy(*steps.doc_sharded_rows_topk_step(
        device_batch._up(dd[0], dev), device_batch._up(ss[0], dev), k,
        group))


def serve_ranked_term_sharded(
    group,
    tsharded,  # parallel.build.TermShardedIndex
    norm_lens: np.ndarray,
    queries: Sequence[Sequence[int]],
    k: int = 10,
    device="cuda",
):
    """Exact ranked top-k over a set of per-term-range indexes.

    The term-partitioned topology: each shard is a self-contained index
    over its term range, and rank j decodes shard j alone, so a query's
    terms are decoded on different ranks and a document's score is
    split over them.  Each rank buckets its partial (docid, score) rows
    by destination doc range; one all_to_all moves them to their doc
    owner, then the doc-sharded sort-merge top-k runs
    (``steps.term_sharded_rows_topk_step``).  Scoring uses the catalog's
    global document frequencies and the global norm_lens.  Returns
    (scores (Q, k) desc, docids (Q, k) global ids) on every rank."""
    from ..query import ranked
    from ..query.term_decode import TermDecoder
    from . import steps

    S = len(tsharded.shards)
    j = _shard_of_rank(S, group, "term shard")
    dev = resolve_device(device)
    norm_lens = np.asarray(norm_lens, np.float32)
    Q = len(queries)
    span = -(-max(tsharded.num_docs, 1) // S)
    tlo, thi = int(tsharded.term_lo[j]), int(tsharded.term_hi[j])
    weighted = [
        [(t, qw) for t, qw in ranked.query_weights_from(
            tsharded.df, tsharded.num_docs, q) if tlo <= int(t) < thi]
        for q in queries
    ]
    local = sorted({int(t) - tlo for w in weighted for t, _ in w})
    dec = TermDecoder(tsharded.shards[j], device=dev)
    docs = dec.decode_docids(local)
    freqs = dec.decode_freqs(local)
    # per[dest][q] = (docids, scores): this rank's rows bucketed by the
    # doc-range owner dest
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    per = [[empty] * Q for _ in range(S)]
    for qi, w in enumerate(weighted):
        ds = [[] for _ in range(S)]
        ss = [[] for _ in range(S)]
        for t, qw in w:
            lt = int(t) - tlo
            d = docs[lt].astype(np.int64)
            s = np.float32(qw) * ranked.doc_term_weight(freqs[lt],
                                                        norm_lens[d])
            dest = np.minimum(d // span, S - 1)
            for dj in np.unique(dest):
                m = dest == dj
                ds[dj].append(d[m].astype(np.int32))
                ss[dj].append(s[m].astype(np.float32))
        for dj in range(S):
            if ds[dj]:
                per[dj][qi] = (np.concatenate(ds[dj]),
                               np.concatenate(ss[dj]))
    # every rank pads to the widest row of any rank (all_to_all moves
    # equal blocks)
    width = torch.tensor(
        [max([k] + [int(d.shape[0]) for dst in per for d, _ in dst])],
        dtype=torch.int64, device=dev)
    dist.all_reduce(width, op=dist.ReduceOp.MAX, group=group)
    dd, ss = pad_shard_rows(per, min_width=int(width.item()))
    return _topk_numpy(*steps.term_sharded_rows_topk_step(
        device_batch._up(dd, dev), device_batch._up(ss, dev), k, group))


def serve_boolean_doc_sharded(
    group,
    sharded,  # parallel.build.DocShardedIndex
    queries: Sequence[Sequence[int]],
    device="cuda",
) -> List[np.ndarray]:
    """Exact boolean AND over a set of per-doc-range indexes.

    Every document lives in exactly one shard, so the global AND is the
    concatenation of the shards' local ANDs (local ids rebased to
    global): rank j decodes and intersects shard j alone, and the
    per-query results are gathered in rank order, which is doc order.
    Returns per-query sorted global docid arrays on every rank,
    identical to and_query on the unsharded index."""
    from ..query import boolean
    from ..query.term_decode import TermDecoder

    j = _shard_of_rank(len(sharded.shards), group, "doc shard")
    all_terms = sorted({int(t) for q in queries for t in q})
    dec = TermDecoder(sharded.shards[j], device=device)
    lo = np.uint32(int(sharded.doc_lo[j]))
    decoded = dec.decode_docids(all_terms)
    local = [boolean.and_query(decoded, q) + lo for q in queries]
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, local, group=group)
    return [
        np.concatenate([p[qi] for p in parts]).astype(np.uint32)
        for qi in range(len(queries))
    ]


def serve_ranked_sharded(
    group,
    index,
    decoder,
    wdata,
    queries: Sequence[Sequence[int]],
    k: int = 10,
    pruned: bool = True,
):
    """Exact ranked top-k of ``queries`` over a real index, doc-sharded
    over the group's ranks, on the decoder's device.  Returns (scores
    (Q, k) desc, docids (Q, k)) on every rank.

    With ``pruned`` and a block-max wand_data sidecar, the rows hold
    only the postings of blocks that survive the Block-Max test on the
    device (``bmw_device.build_pruned_rows_device``): the same top-k,
    less data a rank.  Every rank builds every query's rows and keeps
    its doc range.  The queries run in the power-of-4 size buckets of
    ``device_batch.bucket_queries``, one doc-sharded step a bucket, where
    the reference pads the whole batch to its widest row: at a real
    index's widths that one batch would not fit a card."""
    from . import steps

    dev = decoder.device
    if (
        pruned
        and getattr(wdata, "block_maxw", None) is not None
        and hasattr(decoder, "lazy_cache")
        and hasattr(decoder.lazy_cache, "docs_blocks_batch")
    ):
        from ..query import bmw_device

        drows, srows, _ = bmw_device.build_pruned_rows_device(
            decoder.lazy_cache, index, wdata, queries, k, device=dev
        )
    else:
        drows, srows = device_batch.build_ranked_rows(
            index, decoder, wdata, queries
        )
    S, j = dist.get_world_size(group), dist.get_rank(group)
    vals = np.zeros((len(queries), k), np.float32)
    ids = np.zeros((len(queries), k), np.int32)
    buckets = device_batch.bucket_queries([len(r) for r in drows])
    for _, qi in sorted(buckets.items()):
        dd, ss = shard_rows_by_doc(
            [drows[i] for i in qi], [srows[i] for i in qi], S,
            index.num_docs, min_width=k
        )
        vals[qi], ids[qi] = _topk_numpy(*steps.doc_sharded_rows_topk_step(
            device_batch._up(dd[j], dev), device_batch._up(ss[j], dev), k,
            group))
    return vals, ids
