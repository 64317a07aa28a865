"""Sharded device steps, rank-local torch ops plus collectives.

The port of ``dint_tpu/parallel/steps.py``.  Each function runs on one
rank's shard, inside a process of a ``torch.distributed`` group
(``dist.run_ranks``), and takes the group (``None``: the default one)
where the reference takes the mesh axis under ``shard_map``; a psum
becomes an ``all_reduce``, an ``all_gather`` or ``all_to_all`` the
collective of the same name.  Collectives move int32, int64 or float32
tensors (NCCL takes no uint32).

u32 data travels as int32 bit patterns, or as int64 holding the
unsigned value where an order or a product needs it: the hashes
multiply in int64 reduced mod 2^32 (every right shift then logical),
the selectors take their max in int64 (an int32 max of u32 data goes
wrong at bit 31), and the AND step searches int64 copies of the docids
so that the 0xFFFFFFFF padding sorts last.

``stats_training_step`` is the device half of dictionary training: a
bucketed histogram of sub-block patterns per selector context, built
locally and summed over the ranks.  The exact content counting stays
on the host (``stats/collectors.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import BLOCK_SIZE, NUM_SELECTORS, TARGET_SIZES
from ..kernels import unpack_device
from ..query import device_batch

_MASK32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding the unsigned value of u32 data (int32 bit
    patterns or int64)."""
    return x.to(torch.int64) & _MASK32


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for u32 values z (int64) and a u32 constant c,
    in two 16-bit halves of c so that no int64 product overflows."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise 32-bit mixer (murmur3 finalizer style); u32 results
    in int64."""
    z = _u32(x)
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def selectors(blocks: torch.Tensor) -> torch.Tensor:
    """Selector code per block row (statistics_collectors.hpp:21-40)."""
    mx = _u32(blocks).max(dim=1).values
    sel = ((mx >= 2).to(torch.int32) + (mx >= 4) + (mx >= 16)
           + (mx >= 256) + (mx >= 65536))
    return sel.to(torch.int32)


def window_bucket_hashes(blocks: torch.Tensor, size: int) -> torch.Tensor:
    """(B, BLOCK_SIZE) -> (B, BLOCK_SIZE//size) u32 window hashes (in
    int64)."""
    B = blocks.shape[0]
    wins = blocks.reshape(B, BLOCK_SIZE // size, size)
    h = torch.zeros(wins.shape[:2], dtype=torch.int64, device=blocks.device)
    for t in range(size):
        h = _mul32(h, 0x01000193) ^ mix32(wins[:, :, t])
    return h


def _all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """(Q, k) on every rank -> (Q, S*k): rank s's block at [:, s*k:]."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _merge_topk(lv: torch.Tensor, ld: torch.Tensor, k: int, group):
    """Merge every rank's (Q, k) top-k values and docids into the
    global top-k (the all_gather merge)."""
    gv = _all_gather_cat(lv, group)
    gd = _all_gather_cat(ld, group)
    v, i = torch.topk(gv, k, dim=1)
    return v, torch.gather(gd, 1, i)


def term_sharded_and_step(cand: torch.Tensor, shard_docs: torch.Tensor,
                          shard_valid: torch.Tensor, group=None):
    """Term-sharded boolean AND: every rank holds, for each of the Q
    in-flight queries, (at most) one of its terms' docid lists; the
    cross-rank AND is a sum of misses (queries.hpp:59-79 replaced).

    cand:        (Q, C) candidate docids, the same on every rank
    shard_docs:  (Q, L) this rank's sorted docid list per query
                 (padded with 0xFFFFFFFF)
    shard_valid: (Q,) whether this rank holds a term for the query
    returns      (Q, C) bool: candidate present in every rank's term
    """
    docs = _u32(shard_docs)
    c = _u32(cand)
    pos = torch.searchsorted(docs, c)
    pos = torch.clamp(pos, max=docs.shape[1] - 1)
    hit = torch.gather(docs, 1, pos) == c
    misses = ((~hit) & shard_valid.to(torch.bool)[:, None]).to(torch.int32)
    dist.all_reduce(misses, group=group)
    return misses == 0


def term_sharded_topk_step(shard_scores: torch.Tensor, k: int, group=None):
    """Term-sharded ranked top-k: each rank holds the BM25 contributions
    of its terms to every (query, doc) pair; the global score is their
    sum over the ranks and the top-k runs on every rank.

    shard_scores: (Q, D) this rank's partial scores
    returns       (values (Q, k), doc ids (Q, k))
    """
    total = shard_scores.clone()
    dist.all_reduce(total, group=group)
    return torch.topk(total, k, dim=1)


def doc_sharded_topk_step(local_docs: torch.Tensor,
                          local_scores: torch.Tensor, k: int, group=None):
    """Doc-sharded ranked top-k: each rank fully scores its documents
    for every query, and the global top-k merges the per-rank top-k
    candidates with an all_gather.

    local_docs:   (Q, D) docids owned by this rank
    local_scores: (Q, D) their complete scores on this rank
    returns       (values (Q, k), doc ids (Q, k)), globally exact
    """
    lv, li = torch.topk(local_scores, k, dim=1)
    return _merge_topk(lv, torch.gather(local_docs, 1, li), k, group)


def doc_sharded_rows_topk_step(d: torch.Tensor, s: torch.Tensor, k: int,
                               group=None):
    """Doc-sharded ranked serving over real posting rows: each rank holds,
    per query, the (docid, partial score) rows whose docids fall in its
    doc range (PAD_DOC padded), so its sort-merge sums are complete and
    the per-rank top-k plus the all_gather merge is globally exact.

    The local part is ``device_batch.ranked_union_topk``: a stable sort
    by docid, its segmented scan, the run ends.  The reference sorts
    with ``lax.sort``, which is not stable, so equal docids may add in
    another order there: scores agree to float32 rounding, not bit for
    bit.

    d: (Q, P) int32 docids, s: (Q, P) float32 partial scores (this rank)
    returns (values (Q, k), doc ids (Q, k)), the exact global top-k
    """
    lv, ld = device_batch.ranked_union_topk(d, s, k)
    return _merge_topk(lv, ld, k, group)


def term_sharded_rows_topk_step(d: torch.Tensor, s: torch.Tensor, k: int,
                                group=None):
    """Term-sharded ranked serving over real posting rows: each rank
    decodes only its terms' lists, so a document's contributions are
    spread over the ranks.  One all_to_all sends every row to the rank
    that owns its doc range, after which the doc-sharded step applies
    unchanged.

    d: (S, Q, P) int32 docids, this rank's rows bucketed by destination
       rank (bucket j = docids in rank j's doc range), PAD_DOC padded,
       P the same on every rank; s: same-shape float32 partial scores.
    returns (values (Q, k), doc ids (Q, k)), the exact global top-k
    """
    S, Q, P = d.shape
    rd = torch.empty_like(d)
    rs = torch.empty_like(s)
    dist.all_to_all_single(rd, d.contiguous(), group=group)
    dist.all_to_all_single(rs, s.contiguous(), group=group)
    # (S, Q, P): the rows every source rank holds for MY doc range
    rd = rd.transpose(0, 1).reshape(Q, S * P)
    rs = rs.transpose(0, 1).reshape(Q, S * P)
    return doc_sharded_rows_topk_step(rd, rs, k, group)


def stats_training_step(blocks: torch.Tensor, n_buckets: int = 1 << 16,
                        group=None):
    """One sharded statistics pass over this rank's 256-int gap blocks.

    Returns (counts, selectors): counts is the (NUM_SELECTORS *
    n_buckets,) int64 histogram, summed over the ranks, of the hashed
    windows of every target size bucketed by their block's selector
    context (adjusted::collect, statistics_collectors.hpp:90-107);
    selectors are this rank's blocks' (the caller all_gathers them where
    it wants them all)."""
    sel = selectors(blocks).to(torch.int64)
    idx = []
    for s in TARGET_SIZES:
        bucket = window_bucket_hashes(blocks, s) & (n_buckets - 1)
        idx.append((sel[:, None] * n_buckets + bucket).reshape(-1))
    counts = torch.bincount(torch.cat(idx),
                            minlength=NUM_SELECTORS * n_buckets)
    dist.all_reduce(counts, group=group)
    return counts, sel.to(torch.int32)


# ---------------------------------------------------------------------------
# Sharded ladder decode: a flat value stream's 256-value blocks split into
# contiguous ranges, one a rank, each decoding its width classes
# ---------------------------------------------------------------------------


def ladder_shard_pack(flat_values, n_shards: int):
    """Doc-shard a flat value stream's canonical ladder image (host
    numpy).

    The 256-value blocks split into ``n_shards`` contiguous ranges
    (each block packs on its own at its own ladder width, so the shards'
    images are slices of the whole image:
    ``kernels/unpack_device.ladder_plan_from_values`` geometry).  Each
    width's arrays pad to the largest block count over the shards.

    Returns (packed, counts, order, tail):
      packed  {width: (S, NBw_max, words_w) u32}
      counts  {width: (S,) int32 valid block count}
      order   per-shard per-width original block indices (the host's
              reassembly map)
      tail    (tail_offset, values): the <256-value stream tail, which
              the host decodes, like the single-card engine's partials
    """
    from ..kernels.unpack_device import _LADDER, _ladder_width, _pack_w

    flat = np.ascontiguousarray(flat_values, dtype=np.uint32)
    vpb = BLOCK_SIZE
    nb = flat.shape[0] // vpb
    blocks = flat[: nb * vpb].reshape(nb, vpb)
    tail = (nb * vpb, flat[nb * vpb:].copy())
    S = n_shards
    span = -(-nb // S) if nb else 0
    per_w_blocks = {w: [] for w in _LADDER}
    per_w_order = {w: [] for w in _LADDER}
    for s in range(S):
        b0, b1 = s * span, min((s + 1) * span, nb)
        sl = blocks[b0:b1]
        if sl.shape[0]:
            mx = sl.max(axis=1)
            w_need = np.maximum(
                np.ceil(np.log2(mx.astype(np.float64) + 1.0)), 1
            ).astype(np.int64)
            lw = np.asarray([_ladder_width(int(w)) for w in w_need])
        else:
            lw = np.zeros(0, np.int64)
        for w in _LADDER:
            rows = np.flatnonzero(lw == w)
            per_w_blocks[w].append(sl[rows] if rows.size
                                   else np.zeros((0, vpb), np.uint32))
            per_w_order[w].append(rows + b0)
    packed, counts, order = {}, {}, {}
    for w in _LADDER:
        nmax = max(b.shape[0] for b in per_w_blocks[w])
        if nmax == 0:
            continue
        words = _pack_w(np.zeros((1, vpb), np.uint32), w).shape[1]
        arr = np.zeros((S, nmax, words), np.uint32)
        cnt = np.zeros(S, np.int32)
        for s in range(S):
            b = per_w_blocks[w][s]
            cnt[s] = b.shape[0]
            if b.shape[0]:
                arr[s, : b.shape[0]] = _pack_w(b, w)
        packed[w] = arr
        counts[w] = cnt
        order[w] = per_w_order[w]
    return packed, counts, order, tail


def ladder_sharded_decode_step(packed, counts, group=None):
    """One rank's ladder decode of its shard's width classes.

    ``packed`` {width: (NBw, words) int32 holding u32 words}, this
    rank's slice of ``ladder_shard_pack``'s arrays; ``counts`` {width:
    this rank's valid block count}.  Every class decodes as one
    broadcast shift and mask: value j of a block sits whole in word
    j // vpw at shift (j % vpw) * w.  On the card every class of the
    step is ONE launch of X1's rows entry
    (``unpack_device.ladder_rows``); on the CPU its plain version, the
    torch ops of ``ladder_rows_plain``.  The total decoded-int count is
    summed over the ranks.  Returns ({width: (NBw, 256) int32 holding
    u32}, total)."""
    outs = unpack_device.ladder_rows(packed)
    local = sum(int(counts[w]) * BLOCK_SIZE for w in packed)
    dev = next(iter(packed.values())).device if packed else None
    total = torch.tensor([local], dtype=torch.int64, device=dev)
    dist.all_reduce(total, group=group)
    return outs, int(total.item())
