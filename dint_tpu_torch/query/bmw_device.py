"""Block-Max survival tests on the device, one pass for a whole batch.

The port of ``dint_tpu/query/bmw_device.py``.  The host engine
(query/bmw.py ``prune_blocks``) runs the per-block survival test with
numpy searchsorted + sparse-table range maxima, query by query.  This
module runs the pointwise form of the test as torch ops over the whole
query batch, on the card by default (the reference's step is XLA ops
only, so there is no hand kernel here):

  events     every block b of every query term t contributes two
             events: (docid=lo_b, +ub_b) and (docid=hi_b+1, -ub_b),
             where ub_b = q_weight(t) * block_maxw(t, b).
  sort       one stable sort per batch row on ONE int64 key,
             ``event_key`` = docid * 512 + (1 - is_end) * 16 + slot: at
             equal docids every END applies before any start.
  prefix sum U at every elementary interval = cumsum of the sorted
             deltas, in float64.
  seg-cummax for each term slot k: running max of U with resets at
             slot k's start events (a log-step scan with the
             (max, reset) monoid, all slots in one (T, Q, P) stack).  At
             slot k's end-event positions the scan value is max U over
             that block's docid span.
  survive    byte mask: bit k set at positions that are slot-k end
             events whose running max >= tau(q).  Ships (Q, P) u8 to
             the host in one copy, which reorders bits into per-term
             block masks — end events of one term arrive in block
             order, so the unpack is a boolean compaction
             (``_host_end_order`` replays the sort order from the same
             key).

EXACTNESS.  The host test bounds each block by summing PER-TERM range
maxima; the pointwise U(x) = sum_t ub(block_t(x), t) here is tighter
(max of a sum <= sum of maxes) and still an upper bound of every score
in the block, so the surviving set satisfies query/bmw.py's exactness
proof.  Between a block's start and its end event lie exactly the
events of its docid span: for x = lo the ends at lo come first (they
belong to blocks that stop before lo) and every start at lo is at or
after the block's own start in a prefix sum that already holds the
earlier ones; for x = hi + 1 only ends precede the block's own end,
and they lower U.  The scan value is therefore max U over the span, no
more and no less.

Two decisions differ from the reference and are tested
(tests/test_torch_bmw.py):

* Ends before starts at equal docids.  The reference sorts starts
  first.  Consecutive blocks of one term meet at one docid (hi_b + 1 =
  lo_{b+1}), so with starts first the next block's start resets slot
  k's running max just before block b's end event reads it, and block b
  is judged by U at hi_b + 1 alone: it can be pruned although U reaches
  tau inside its span.  With ends first every block reads its whole
  span.
* The prefix sum in float64, compared with tau in float64.  The deltas
  are float32 values, so the float64 sum is the same on the CPU and on
  the card whatever order a parallel scan adds in, and it is never
  below the true bound by float32 rounding; tau is shaved by only 1e-6.

``EVENT_CAP`` and ``MAX_SLOTS`` decide which queries take the host test
and so change ``blocks_kept``: module constants with the reference's
values, and keyword arguments; no environment variable is read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from . import bmw as bmw_mod
from . import ranked as ranked_mod
from .device_batch import PAD_DOC

# term slots per query supported by one survival byte
MAX_SLOTS = 8

# queries whose event row exceeds EVENT_CAP take the host test (few
# monster unions); every device row is padded to the widest one
EVENT_CAP = 1 << 15

PAD_SLOT = 255


def event_key(docid, is_end, slot):
    """The sort key of an event, from int64 numpy arrays or tensors:
    docid first, ends before starts, then the slot, which makes the key
    unique in a row.  Pad events (docid int32 max, start, slot 255) sort
    last."""
    return docid * 512 + (1 - is_end) * 16 + slot


def _seg_cummax(u: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """Running max of ``u`` along the last axis with a restart where
    ``resets`` is True: the monoid (m, r) . (m2, r2) = (m2 if r2 else
    max(m, m2), r | r2) in log2(P) doubling steps.  ``maximum`` is exact
    whatever the order."""
    P = u.shape[-1]
    m = u.clone(memory_format=torch.contiguous_format)
    f = resets.clone()
    k = 1
    while k < P:
        best = torch.maximum(m[..., k:], m[..., :-k])
        m[..., k:] = torch.where(f[..., k:], m[..., k:], best)
        f[..., k:] = f[..., k:] | f[..., :-k]
        k *= 2
    return m


def survival(docid, is_end, delta, slot, tau, T: int) -> torch.Tensor:
    """The survival pass on the tensors' device.  ``docid`` (Q, P) int32,
    ``is_end`` (Q, P) uint8, ``delta`` (Q, P) float32, ``slot`` (Q, P)
    uint8 in event-build order, ``tau`` (Q,) float64, ``T`` the number of
    term slots in use.  Returns (Q, P) uint8 in SORTED order: bit k set
    where a slot-k end event's block reaches tau."""
    key = event_key(docid.to(torch.int64), is_end.to(torch.int64),
                    slot.to(torch.int64))
    _, order = torch.sort(key, dim=1, stable=True)
    delta_s = torch.gather(delta, 1, order)
    slot_s = torch.gather(slot, 1, order)
    end_s = torch.gather(is_end, 1, order)
    u = torch.cumsum(delta_s.to(torch.float64), dim=1)
    ks = torch.arange(T, device=docid.device).view(T, 1, 1)
    is_k = slot_s.unsqueeze(0) == ks
    starts = is_k & (end_s == 0)
    ends = is_k & (end_s == 1)
    m = _seg_cummax(u.unsqueeze(0).expand(T, -1, -1), starts)
    hit = ends & (m >= tau.to(torch.float64).view(1, -1, 1))
    bits = torch.bitwise_left_shift(hit.to(torch.int32), ks.to(torch.int32))
    return bits.sum(dim=0).to(torch.uint8)


def build_events(rows, P: int):
    """The (Q, P) event arrays of ``rows``, a list of per-query
    [(term, (lo, hi, ub)), ...] geometries (slot = position in the
    list): docid int32, is_end uint8, delta float32, slot uint8.  A
    term's starts then its ends, block order inside each."""
    Q = len(rows)
    docid = np.full((Q, P), np.iinfo(np.int32).max, np.int32)
    is_end = np.zeros((Q, P), np.uint8)
    delta = np.zeros((Q, P), np.float32)
    slot = np.full((Q, P), PAD_SLOT, np.uint8)
    for r, geoms in enumerate(rows):
        pos = 0
        for sk, (_, (lo, hi, ub)) in enumerate(geoms):
            nb = lo.shape[0]
            docid[r, pos:pos + nb] = lo
            delta[r, pos:pos + nb] = ub
            slot[r, pos:pos + nb] = sk
            pos += nb
            docid[r, pos:pos + nb] = hi.astype(np.int64) + 1
            delta[r, pos:pos + nb] = -ub
            slot[r, pos:pos + nb] = sk
            is_end[r, pos:pos + nb] = 1
            pos += nb
    return docid, is_end, delta, slot


def plan_batch(cache, index, wdata, queries, k: int, taus_hint=None,
               event_cap: int = EVENT_CAP, max_slots: int = MAX_SLOTS):
    """Host planning of one batch: per query None (no term), ("host",
    weighted, keep masks) for the queries that take the host test (more
    than ``max_slots`` terms, or an event row over ``event_cap``), or
    ("dev", weighted, [(term, (lo, hi, ub)), ...]); with each query's
    tau and the common event width P.  tau comes from ``taus_hint``
    where the caller has a valid lower bound (e.g. the serving store's
    per-term top-k tables: real achievable partial totals, no
    probe-block decode), else from probe blocks."""
    if wdata.block_maxw is None:
        raise ValueError("wand_data has no block-max sidecar")
    if max_slots > 8:
        raise ValueError("one survival byte holds at most 8 term slots")
    shared = {}        # device geometry cache: (term, qw) -> geometry
    shared_host = {}   # host-fallback cache (carries _RangeMax tables)
    per_q = []
    taus = []
    P_need = 1
    for qi, q in enumerate(queries):
        weighted = ranked_mod._query_weights(index, q)
        if not weighted:
            per_q.append(None)
            taus.append(0.0)
            continue
        geoms = []
        ev = 0
        if len(weighted) <= max_slots:
            for t, qw in weighted:
                key = (t, float(qw))
                if key not in shared:
                    shared[key] = bmw_mod._term_geom(index, wdata, t, qw)
                geoms.append((t, shared[key]))
                ev += 2 * shared[key][0].shape[0]
        if len(weighted) > max_slots or ev > event_cap:
            keep, tau, _ = bmw_mod.prune_blocks(
                cache, index, wdata, q, k, _cache=shared_host)
            per_q.append(("host", weighted, keep))
            taus.append(tau)
            continue
        if taus_hint is not None and taus_hint[qi] is not None:
            tau = float(taus_hint[qi])
        else:
            tau = bmw_mod.estimate_tau(cache, index, wdata, weighted, k)
        tau *= 1.0 - 1e-6  # same f32-rounding shave as the host test
        per_q.append(("dev", weighted, geoms))
        taus.append(float(tau))
        P_need = max(P_need, ev)
    P = 1 << max(int(np.ceil(np.log2(P_need))), 3)
    return per_q, taus, P


def prune_blocks_device(
    cache,
    index,
    wdata,
    queries: Sequence[Sequence[int]],
    k: int,
    taus_hint: Sequence[Optional[float]] = None,
    device="cuda",
    event_cap: int = EVENT_CAP,
    max_slots: int = MAX_SLOTS,
) -> Tuple[List[Dict[int, np.ndarray]], List[float], Dict[str, int]]:
    """Batched device survival tests for many queries at once.

    Returns (per-query {term: keep bool mask}, taus, stats) with the
    same contract as bmw.prune_blocks pass 1 (the point-bound
    refinement pass stays host-side).  tau estimation stays on the
    host (``plan_batch``).  The event arrays are built in numpy,
    uploaded once to ``device``, and the (Q, P) byte mask comes back in
    one copy."""
    dev = resolve_device(device)
    per_q, taus, P = plan_batch(cache, index, wdata, queries, k, taus_hint,
                                event_cap, max_slots)
    dev_rows = [i for i, p in enumerate(per_q)
                if p is not None and p[0] == "dev"]
    keeps: List[Dict[int, np.ndarray]] = [None] * len(queries)
    stats = {"device_queries": len(dev_rows),
             "host_fallback_queries":
                 sum(1 for p in per_q if p is not None and p[0] == "host"),
             "event_width": P}
    if dev_rows:
        rows = [per_q[qi][2] for qi in dev_rows]
        docid, is_end, delta, slot = build_events(rows, P)
        tau_arr = np.asarray([taus[qi] for qi in dev_rows], np.float64)
        T = max(len(g) for g in rows)
        up = lambda a: torch.from_numpy(a).to(dev)
        out = survival(up(docid), up(is_end), up(delta), up(slot),
                       up(tau_arr), T).cpu().numpy()
        for qi, keep in zip(dev_rows,
                            unpack_masks(out, docid, is_end, slot, rows)):
            keeps[qi] = keep
    for qi, p in enumerate(per_q):
        if p is not None and p[0] == "host":
            keeps[qi] = p[2]
    return keeps, taus, stats


def unpack_masks(out, docid, is_end, slot, rows):
    """Per row {term: keep bool mask} from ``survival``'s (Q, P) bytes
    in sorted order: slot-k end events in sorted order ARE that term's
    blocks in block order (disjoint spans, increasing hi), so bit k at
    those positions is the term's mask."""
    ends_sorted = _host_end_order(docid, is_end, slot)
    keeps = []
    for r, geoms in enumerate(rows):
        keep = {}
        for sk, (t, (lo, hi, ub)) in enumerate(geoms):
            sel = ends_sorted[r] == sk
            bits = (out[r][sel] >> sk) & 1
            assert bits.shape[0] == lo.shape[0], (t, bits.shape, lo.shape)
            keep[t] = bits.astype(bool)
        keeps.append(keep)
    return keeps


def _host_end_order(docid, is_end, slot):
    """Host replay of the device sort ORDER (keys only, no values): for
    each row, the slot id at each sorted position for end events (255
    elsewhere).  numpy's stable argsort on ``event_key`` is the order of
    ``survival``'s stable sort on the same key, position for position;
    the key is unique in a row but for the pad events, which carry no
    end."""
    key = event_key(docid.astype(np.int64), is_end.astype(np.int64),
                    slot.astype(np.int64))
    order = np.argsort(key, axis=1, kind="stable")
    slot_s = np.take_along_axis(slot, order, axis=1)
    end_s = np.take_along_axis(is_end, order, axis=1)
    return np.where(end_s == 1, slot_s, PAD_SLOT)


def build_pruned_rows_device(
    cache,
    index,
    wdata,
    queries: Sequence[Sequence[int]],
    k: int,
    device="cuda",
):
    """device-test variant of bmw.build_pruned_rows: survival masks
    from ONE device pass, survivor decode + row assembly on the host as
    before.  Returns (drows, srows, stats)."""
    if int(getattr(index, "num_docs", 0)) > int(PAD_DOC):
        raise ValueError(
            f"device batch engine requires docids < 2^31-1; index has "
            f"num_docs={index.num_docs}"
        )
    keeps, taus, dstats = prune_blocks_device(
        cache, index, wdata, queries, k, device=device)
    agg = {"postings_total": 0, "postings_kept": 0, "blocks_total": 0,
           "blocks_kept": 0, **dstats}
    plans = []
    need = []
    for qi, q in enumerate(queries):
        weighted = ranked_mod._query_weights(index, q)
        if not weighted:
            plans.append((None, None))
            continue
        keep = keeps[qi]
        plans.append((weighted, keep))
        for t, _ in weighted:
            m = keep[t]
            sizes = bmw_mod._block_sizes(index, t, m.shape[0])
            agg["postings_total"] += int(index.list_n[t])
            agg["postings_kept"] += int(sizes[m].sum())
            agg["blocks_total"] += m.shape[0]
            agg["blocks_kept"] += int(m.sum())
            p0, _ = index.list_blocks(t)
            need.extend((t, p0 + int(rb)) for rb in np.flatnonzero(m))
    need = list(dict.fromkeys(need))
    cache.docs_blocks_batch(need)
    cache.freqs_blocks_batch(need)
    drows, srows = [], []
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
        drows.append(np.concatenate(dparts) if dparts
                     else np.zeros(0, np.int32))
        srows.append(np.concatenate(sparts).astype(np.float32)
                     if sparts else np.zeros(0, np.float32))
    return drows, srows, agg
