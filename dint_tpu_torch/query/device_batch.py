"""Device-batched query execution — sort-merge set algebra on the card.

The port of ``dint_tpu/query/device_batch.py``.  A whole batch of queries
executes as a handful of device calls over dense padded arrays (queries
group into power-of-4 size buckets so one monster union cannot inflate
the whole batch's padding), and every merge is sort + segmented scan +
top-k, as torch ops on the tensors' device:

* ranked_or: concatenate each query's (docid, partial BM25 score)
  postings, sort by docid (stable), segmented-sum scores within equal
  docid runs (Hillis-Steele segmented scan, log2(P) shifted adds), then
  top-k over run ends.  The same ops in the same order as the reference,
  so on the CPU the scores equal the reference's bit for bit.
* and / or counts: the same sort, runs of length == num_terms (AND) or
  run-end count (OR).  Exact integer results.

The host decodes postings (``TermDecoder``) and pads the batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import ranked as ranked_mod

PAD_DOC = np.int32(2**31 - 1)


def _check_docid_range(docs) -> None:
    """Docids are sorted as int32 with PAD_DOC = 2^31-1 as the padding
    sentinel; a docid >= 2^31-1 would wrap negative (mis-sort) or
    collide with the pad.  Reject such collections up front instead of
    silently corrupting results."""
    for t, d in docs.items():
        if d.size and int(d[-1]) >= int(PAD_DOC):
            raise ValueError(
                f"device batch engine requires docids < 2^31-1; term {t} "
                f"has docid {int(d[-1])}"
            )


def _next_pow2(x: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(x, 1)))), 5)


# ---------------------------------------------------------------------------
# Device functions (torch ops on the tensors' device)
# ---------------------------------------------------------------------------


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x shifted k lanes to the right along the last axis, the first k
    lanes set to ``fill`` (jnp.pad(x, ((0,0),(k,0)))[:, :P])."""
    head = torch.full((x.shape[0], k), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:, : x.shape[1] - k]], dim=1)


def _seg_scan(x: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan along the last axis: x (Q, P) values,
    start (Q, P) bool segment-start flags; per-position inclusive sums
    that reset at segment starts."""
    P = x.shape[-1]
    f = start
    k = 1
    while k < P:
        xs = _shift_right(x, k, 0)
        fs = _shift_right(f, k, True)
        x = x + torch.where(f, torch.zeros_like(x), xs)
        f = f | fs
        k *= 2
    return x


def _run_starts(d: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(d[:, :1], dtype=torch.bool)
    return torch.cat([first, d[:, 1:] != d[:, :-1]], dim=1)


def _run_ends(d: torch.Tensor) -> torch.Tensor:
    last = torch.ones_like(d[:, :1], dtype=torch.bool)
    return torch.cat([d[:, :-1] != d[:, 1:], last], dim=1)


def ranked_union_topk(d: torch.Tensor, s: torch.Tensor, k: int):
    """d (Q, P) int32 docids (PAD_DOC padded), s (Q, P) float32 partial
    scores; per-docid score sums; returns (top-k scores desc, top-k
    docids) per query."""
    d, order = torch.sort(d, dim=1, stable=True)
    s = torch.gather(s, 1, order)
    sums = _seg_scan(s, _run_starts(d))
    valid = d != int(PAD_DOC)
    cand = torch.where(_run_ends(d) & valid, sums,
                       torch.full_like(sums, -np.inf))
    top, idx = torch.topk(cand, k, dim=1)
    return top, torch.gather(d, 1, idx)


def _and_runs(d: torch.Tensor, nterms: torch.Tensor):
    d, _ = torch.sort(d, dim=1, stable=True)
    ones = torch.ones(d.shape, dtype=torch.float32, device=d.device)
    runlen = _seg_scan(ones, _run_starts(d))
    is_end = _run_ends(d) & (d != int(PAD_DOC))
    member = is_end & (runlen.to(torch.int32) == nterms[:, None])
    return d, is_end, member


def boolean_counts(d: torch.Tensor, nterms: torch.Tensor):
    """d (Q, P) int32 concatenated docids of each query's distinct
    terms; nterms (Q,) int32.  Returns (and_count, or_count) per query:
    runs of length == nterms are intersection members; every run is a
    union member."""
    _, is_end, member = _and_runs(d, nterms)
    return member.sum(dim=1), is_end.sum(dim=1)


def and_members(d: torch.Tensor, nterms: torch.Tensor):
    """Sorted docids with the intersection membership mask."""
    d, _, member = _and_runs(d, nterms)
    return d, member


# ---------------------------------------------------------------------------
# Host-side batch assembly
# ---------------------------------------------------------------------------


def pad_batch(rows: List[np.ndarray], pad_val, dtype) -> np.ndarray:
    P = _next_pow2(max((r.shape[0] for r in rows), default=1))
    out = np.full((len(rows), P), pad_val, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


def bucket_queries(lengths: Sequence[int]) -> Dict[int, List[int]]:
    """Group query indices by padded posting count (powers of 4, so at
    most 4x padding waste and a handful of shapes) — one long query must
    not inflate the whole batch's padded width."""
    buckets: Dict[int, List[int]] = {}
    for i, ln in enumerate(lengths):
        p = 1 << max(int(np.ceil(np.log2(max(ln, 1)))), 5)
        if (p.bit_length() - 1) % 2:
            p <<= 1  # powers of 4
        buckets.setdefault(p, []).append(i)
    return buckets


def build_ranked_rows(
    index,
    decoder,
    wdata,
    queries: Sequence[Sequence[int]],
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-query (docids i32, scores f32) union posting rows: the
    per-(term, doc) BM25 partials (query weight x doc term weight), the
    quantities the reference computes inside its enumerator loops
    (queries.hpp:262-276)."""
    all_terms = sorted({int(t) for q in queries for t in q})
    docs = decoder.decode_docids(all_terms)
    freqs = decoder.decode_freqs(all_terms)
    _check_docid_range(docs)
    drows, srows = [], []
    for q in queries:
        weighted = ranked_mod._query_weights(index, q)
        if not weighted:
            drows.append(np.zeros(0, np.int32))
            srows.append(np.zeros(0, np.float32))
            continue
        dr = np.concatenate([docs[t] for t, _ in weighted])
        sr = np.concatenate(
            [
                np.float32(qw)
                * ranked_mod.doc_term_weight(
                    freqs[t], wdata.norm_lens[docs[t].astype(np.int64)]
                )
                for t, qw in weighted
            ]
        )
        drows.append(dr.astype(np.int32))
        srows.append(sr.astype(np.float32))
    return drows, srows


def build_boolean_rows(
    decoder, queries: Sequence[Sequence[int]]
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Per-query concatenated docid rows + nterms for AND/OR counting."""
    from .boolean import dedup_terms

    all_terms = sorted({int(t) for q in queries for t in q})
    docs = decoder.decode_docids(all_terms)
    _check_docid_range(docs)
    drows, nterms = [], []
    for q in queries:
        terms = dedup_terms(q)
        if terms:
            drows.append(
                np.concatenate([docs[t] for t in terms]).astype(np.int32)
            )
        else:
            drows.append(np.zeros(0, np.int32))
        nterms.append(len(terms))
    return drows, np.asarray(nterms, np.int32)


def _up(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# Public batched entry points
# ---------------------------------------------------------------------------


def ranked_or_batch(
    index, decoder, wdata, queries: Sequence[Sequence[int]], k: int = 10
) -> List[np.ndarray]:
    """Top-k scores (descending) per query — one device call per size
    bucket on the decoder's device."""
    drows, srows = build_ranked_rows(index, decoder, wdata, queries)
    out: List[np.ndarray] = [None] * len(queries)
    for P, idxs in sorted(bucket_queries([len(r) for r in drows]).items()):
        d = pad_batch([drows[i] for i in idxs], PAD_DOC, np.int32)
        s = pad_batch([srows[i] for i in idxs], 0.0, np.float32)
        top, _ = ranked_union_topk(_up(d, decoder.device),
                                   _up(s, decoder.device), k)
        top = top.cpu().numpy()
        for row, i in zip(top, idxs):
            out[i] = row[np.isfinite(row)].astype(np.float32)
    return out


def boolean_count_batch(
    decoder, queries: Sequence[Sequence[int]], op: str
) -> np.ndarray:
    """AND or OR result-set sizes per query, one device call per bucket."""
    drows, nterms = build_boolean_rows(decoder, queries)
    res = np.zeros(len(queries), np.int64)
    for P, idxs in sorted(bucket_queries([len(r) for r in drows]).items()):
        d = pad_batch([drows[i] for i in idxs], PAD_DOC, np.int32)
        and_c, or_c = boolean_counts(_up(d, decoder.device),
                                     _up(nterms[idxs], decoder.device))
        res[idxs] = (and_c if op == "and" else or_c).cpu().numpy()
    return res


def and_results_batch(
    decoder, queries: Sequence[Sequence[int]]
) -> List[np.ndarray]:
    """Exact AND result docid arrays per query (device merge, host
    compaction of the membership mask)."""
    drows, nterms = build_boolean_rows(decoder, queries)
    out: List[np.ndarray] = [None] * len(queries)
    for P, idxs in sorted(bucket_queries([len(r) for r in drows]).items()):
        d = pad_batch([drows[i] for i in idxs], PAD_DOC, np.int32)
        ds, mask = and_members(_up(d, decoder.device),
                               _up(nterms[idxs], decoder.device))
        ds, mask = ds.cpu().numpy(), mask.cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = ds[j][mask[j]].astype(np.uint32)
    return out
