"""Fused device serving: a device-resident postings store, no host bounce.

The port of ``dint_tpu/query/device_serve.py``.  The index's postings are
decoded ONCE at load (``TermDecoder`` on the card) into a per-block store
in device memory, and each query batch is served per size bucket by K4,
a block copy that materializes the batch's (docid, score) rows straight
from the store (``block_copy``, hand-written CUDA in
``kernels/csrc/serve_gather.cu``), then the sort-merge top-k of
``_bucket_topk`` as torch ops.  The host contributes only the per-batch
metadata: one int32 block id + one float32 query weight per touched
256-block.  All buckets of a pass are issued on one stream and the host
waits once, when the top-k comes back.

Store layout (the index's 256-posting block structure,
dict_posting_list.hpp:14-56):
  * docids  (NB, 256) int32 — block b of term t at row blk_off[t]+b;
    tail lanes of a term's last block hold PAD_DOC.
  * dtw     (NB, 256) float32 — the query-independent BM25 factor
    doc_term_weight(freq, norm_len[docid]) per posting; the score of a
    (term, query) posting is qw * dtw, one f32 product in K4.  Tail
    lanes hold 0.
  * row NB-1 is a dedicated all-PAD block: unused tile slots of a
    padded batch point there with qw 0.

Block-Max pruning (``prune=True`` with a lazy block cache and a
block-max sidecar): the survival pass of ``query/bmw_device.py`` runs on
the store's device before the batch is shaped, and the blocks that
cannot reach a query's top-k leave its block id list, so K4 copies and
the sort-merge sorts only the survivors.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import cuda_ext
from . import bmw_device, device_batch
from . import ranked as ranked_mod

PAD_DOC = device_batch.PAD_DOC
BLOCK = 256

# ---------------------------------------------------------------------------
# K4: block copy by block id
# ---------------------------------------------------------------------------

_LIB = "libdintserve.so"


def block_copy_plain(blk, qw, dstore, wstore):
    """K4's plain version: d[g] = dstore[blk[g]], s[g] = wstore[blk[g]] *
    qw[g] (one f32 product, as ``take(wstore) * qw`` in the reference's
    portable path).  A block id outside [0, NB) names the PAD row NB-1,
    as in the kernel."""
    NB = dstore.shape[0]
    blk = torch.where((blk >= 0) & (blk < NB), blk, NB - 1)
    d = torch.index_select(dstore, 0, blk)
    s = torch.index_select(wstore, 0, blk) * qw[:, None]
    return d, s


def block_copy(blk, qw, dstore, wstore):
    """K4: copy the G store rows named by ``blk`` (G,) int32 out of
    ``dstore`` (NB, 256) int32 and ``wstore`` (NB, 256) float32, the
    score rows scaled by ``qw`` (G,) float32.  Returns ((G, 256) int32,
    (G, 256) float32).  On a CUDA tensor it launches the CUDA kernel (or
    raises); on a CPU tensor it runs the plain version.  On both paths a
    block id outside [0, NB) names the PAD row NB-1, so that no id reads
    outside the store."""
    G = blk.shape[0] if blk.dim() == 1 else -1
    if blk.dtype != torch.int32 or G < 0:
        raise ValueError(f"block_copy: blk must be (G,) int32, got "
                         f"{tuple(blk.shape)} {blk.dtype}")
    if qw.dtype != torch.float32 or tuple(qw.shape) != (G,):
        raise ValueError(f"block_copy: qw must be ({G},) float32, got "
                         f"{tuple(qw.shape)} {qw.dtype}")
    NB = dstore.shape[0]
    if (dstore.dtype != torch.int32 or dstore.dim() != 2
            or dstore.shape[1] != BLOCK or NB < 1):
        raise ValueError(f"block_copy: dstore must be (NB, {BLOCK}) int32, "
                         f"got {tuple(dstore.shape)} {dstore.dtype}")
    if wstore.dtype != torch.float32 or tuple(wstore.shape) != (NB, BLOCK):
        raise ValueError(f"block_copy: wstore must be ({NB}, {BLOCK}) "
                         f"float32, got {tuple(wstore.shape)} {wstore.dtype}")
    dev = blk.device
    if not (qw.device == dstore.device == wstore.device == dev):
        raise ValueError("block_copy: tensors on different devices")
    if dev.type == "cpu":
        return block_copy_plain(blk, qw, dstore, wstore)
    if dev.type != "cuda":
        raise ValueError(f"block_copy: unsupported device {dev}")
    for t in (blk, qw, dstore, wstore):
        if not t.is_contiguous():
            raise ValueError("block_copy: every tensor must be contiguous")
    for t in (dstore, wstore):
        if t.data_ptr() % 16:
            raise ValueError("block_copy: the stores must be 16-byte aligned")
    d = torch.empty((G, BLOCK), dtype=torch.int32, device=dev)
    s = torch.empty((G, BLOCK), dtype=torch.float32, device=dev)
    if G == 0:
        return d, s
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_ext.lib(_LIB).dint_block_copy(
        blk.data_ptr(), qw.data_ptr(), dstore.data_ptr(), wstore.data_ptr(),
        d.data_ptr(), s.data_ptr(), G, NB, stream,
    )
    cuda_ext.check(_LIB, "dint_block_copy", rc)
    block_copy.launches += 1
    return d, s


block_copy.launches = 0

KERNELS = {"K4_block_copy": block_copy}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


# ---------------------------------------------------------------------------
# Sort-merge top-k of one bucket (torch ops)
# ---------------------------------------------------------------------------


def _topk_rows(cand: torch.Tensor, d: torch.Tensor, k: int):
    """Exact per-row top-k that stays fast at monster widths: rows
    wider than 2^18 reduce hierarchically (per-chunk top-k, then top-k
    of the R x C*k candidates) — the global top-k is a subset of the
    union of chunk top-ks, so the scores are identical."""
    R, P = cand.shape
    CH = 1 << 14
    if P > (1 << 18) and P % CH == 0:
        C = P // CH
        t, i = torch.topk(cand.reshape(R * C, CH), k, dim=1)
        dd = torch.gather(d.reshape(R * C, CH), 1, i)
        cand = t.reshape(R, C * k)
        d = dd.reshape(R, C * k)
    top, idx = torch.topk(cand, k, dim=1)
    return top, torch.gather(d, 1, idx)


def _bucket_topk(d: torch.Tensor, s: torch.Tensor, P: int, k: int,
                 tmax: int, shift: int = 0):
    """Sort-merge union top-k of one bucket's copied rows.  ``shift``
    rolls each row first (the results are roll-invariant); the reference
    rolls to defeat its runtime's memoisation of identical runs, which
    CUDA does not do, so the card path passes 0."""
    d = d.reshape(-1, P)
    s = s.reshape(-1, P)
    if shift:
        d = torch.roll(d, shift, 1)
        s = torch.roll(s, shift, 1)
    neg = torch.tensor(-np.inf, dtype=torch.float32, device=s.device)
    if tmax == 1:
        # single-term rows: docids are unique — no merge, no sort
        return _topk_rows(torch.where(d != int(PAD_DOC), s, neg), d, k)
    d, order = torch.sort(d, dim=1, stable=True)
    s = torch.gather(s, 1, order)
    # per-docid sums: a docid appears at most once per distinct query
    # term, so every equal-docid run has length <= tmax — tmax-1
    # shifted masked adds, in the reference's order
    x = s
    for j in range(1, tmax):
        dj = device_batch._shift_right(d, j, -1)
        sj = device_batch._shift_right(s, j, 0.0)
        x = x + torch.where(dj == d, sj, torch.zeros_like(sj))
    cand = torch.where(device_batch._run_ends(d) & (d != int(PAD_DOC)), x,
                       neg)
    return _topk_rows(cand, d, k)


class DeviceServingStore:
    """Decode-once device-resident ranked serving for a built index.

    The constructor decodes every posting list of ``terms`` (all terms
    by default) once through ``decoder`` and uploads the block store to
    the decoder's device; ``ranked_topk`` then serves whole query
    batches with no host row prep.  ``build_timings`` holds the wall
    seconds of the build's phases."""

    def __init__(self, index, decoder, wdata,
                 terms: Optional[Sequence[int]] = None):
        self.index = index
        self.wdata = wdata
        self.device = decoder.device
        num_lists = int(index.num_lists)
        if terms is None:
            terms = range(num_lists)
        terms = sorted({int(t) for t in terms})
        t0 = time.perf_counter()
        docs = decoder.decode_docids(terms)
        freqs = decoder.decode_freqs(terms)
        t1 = time.perf_counter()
        device_batch._check_docid_range(docs)
        norm = np.asarray(wdata.norm_lens, np.float32)
        # block offsets over the FULL term space (absent terms: 0 blocks)
        nb = np.zeros(num_lists, np.int64)
        for t in terms:
            nb[t] = -(-docs[t].shape[0] // BLOCK) if docs[t].shape[0] else 0
        blk_off = np.zeros(num_lists + 1, np.int64)
        np.cumsum(nb, out=blk_off[1:])
        NB = int(blk_off[-1]) + 1  # +1: dedicated all-PAD block (row NB-1)
        dstore = np.full((NB, BLOCK), PAD_DOC, np.int32)
        wstore = np.zeros((NB, BLOCK), np.float32)
        # per-term top-K0 (dtw, docid) tables: a SINGLE-term query's
        # score is qw * dtw with qw > 0 constant, so its exact top-k is
        # qw * the precomputed top-k dtw of the list — a host table
        # lookup, no device work.  Queries with >= 2 distinct terms go
        # through the sort-merge engine.
        K0 = 256
        self.topk_dtw: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for t in terms:
            d = docs[t]
            n = d.shape[0]
            if not n:
                continue
            f = freqs[t]
            dtw = ranked_mod.doc_term_weight(
                f, norm[d.astype(np.int64)]
            ).astype(np.float32)
            r0 = int(blk_off[t])
            rows = int(nb[t])
            flat_d = dstore[r0:r0 + rows].reshape(-1)
            flat_w = wstore[r0:r0 + rows].reshape(-1)
            flat_d[:n] = d
            flat_w[:n] = dtw
            if n > K0:
                part = np.argpartition(dtw, n - K0)[n - K0:]
                order = part[np.argsort(-dtw[part], kind="stable")]
            else:
                order = np.argsort(-dtw, kind="stable")
            self.topk_dtw[t] = (dtw[order].copy(), d[order].copy())
        t2 = time.perf_counter()
        self.topk_k0 = K0
        self.blk_off = blk_off
        self.nb = nb
        self.NB = NB
        self.store_bytes = int(dstore.nbytes + wstore.nbytes)
        self._dstore = torch.from_numpy(dstore).to(self.device)
        self._wstore = torch.from_numpy(wstore).to(self.device)
        if self._dstore.is_cuda:
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        self.build_timings = {"decode_s": t1 - t0, "term_loop_s": t2 - t1,
                              "upload_s": t3 - t2}
        self.build_s = t3 - t0

    # ---------------------------------------------------------- batches

    def _batch_metadata(self, queries: Sequence[Sequence[int]], k: int,
                        prune: bool = True, lazy_cache=None):
        """Per-size-bucket {P: (query idxs, blk (G,) i32, qw (G,) f32,
        tmax)}, the table-answered single-term queries {qi: (t, qw)} and
        the stats (``blocks_total`` touched, ``blocks_kept`` shipped).

        With ``prune``, a block-max sidecar and a lazy block cache, the
        survival pass (query/bmw_device.py, on the store's device) drops
        dead blocks before the batch is shaped (exact: a failed block's
        best score cannot enter the final top-k); its ``device_queries``,
        ``host_fallback_queries`` and ``event_width`` join the stats."""
        keeps = None
        stats = {"blocks_total": 0, "blocks_kept": 0}
        weighted = [ranked_mod._query_weights(self.index, q)
                    for q in queries]
        # single-term queries resolve from the per-term top-K0 table
        # (exact by score monotonicity in dtw)
        singles: Dict[int, Tuple[int, float]] = {}
        for qi, wlist in enumerate(weighted):
            if len(wlist) == 1 and k <= self.topk_k0:
                singles[qi] = wlist[0]
        stats["single_term_queries"] = len(singles)
        if (prune
                and getattr(self.wdata, "block_maxw", None) is not None
                and lazy_cache is not None):
            multi_idx = [qi for qi in range(len(queries))
                         if qi not in singles]
            if multi_idx:
                hints = [self.tau_from_tables(weighted[qi], k)
                         for qi in multi_idx]
                mkeeps, _taus, pstats = bmw_device.prune_blocks_device(
                    lazy_cache, self.index, self.wdata,
                    [queries[qi] for qi in multi_idx], k,
                    taus_hint=hints, device=self.device)
                keeps = [None] * len(queries)
                for j, qi in enumerate(multi_idx):
                    keeps[qi] = mkeeps[j]
                stats.update(pstats)
        per_q_blocks: List[Optional[np.ndarray]] = []
        per_q_qw: List[Optional[np.ndarray]] = []
        for qi, wlist in enumerate(weighted):
            if qi in singles:
                per_q_blocks.append(None)
                per_q_qw.append(None)
                continue
            bs, ws = [], []
            for t, qw in wlist:
                nbt = int(self.nb[t])
                if not nbt:
                    continue
                ids = np.arange(
                    int(self.blk_off[t]), int(self.blk_off[t]) + nbt,
                    dtype=np.int32)
                stats["blocks_total"] += nbt
                if keeps is not None and keeps[qi] is not None:
                    m = keeps[qi].get(int(t))
                    if m is not None:
                        assert m.shape[0] == nbt, (t, m.shape, nbt)
                        ids = ids[m]
                stats["blocks_kept"] += ids.shape[0]
                bs.append(ids)
                ws.append(np.full(ids.shape[0], qw, np.float32))
            per_q_blocks.append(
                np.concatenate(bs) if bs else np.zeros(0, np.int32))
            per_q_qw.append(
                np.concatenate(ws) if ws else np.zeros(0, np.float32))
        # bucket by BLOCK count: powers of 4 below 4096 tiles (one
        # monster union must not inflate the whole batch's padding),
        # exact powers of 2 above (monster buckets are few)
        grouped: Dict[int, List[int]] = {}
        for i, b in enumerate(per_q_blocks):
            if b is None:  # table-answered single-term query
                continue
            wb = max(b.shape[0], 1)
            p2 = 1 << int(np.ceil(np.log2(wb)))
            if p2 < (1 << 12) and (p2.bit_length() - 1) % 2:
                p2 <<= 1
            grouped.setdefault(p2, []).append(i)
        buckets = {}
        for tiles, idxs in grouped.items():
            blk = np.full((len(idxs), tiles), self.NB - 1, np.int32)
            qw = np.zeros((len(idxs), tiles), np.float32)
            for r, i in enumerate(idxs):
                nbq = per_q_blocks[i].shape[0]
                blk[r, :nbq] = per_q_blocks[i]
                qw[r, :nbq] = per_q_qw[i]
            tmax = max((len(weighted[i]) for i in idxs), default=1)
            buckets[tiles * BLOCK] = (idxs, blk.reshape(-1),
                                      qw.reshape(-1), max(tmax, 1))
        return buckets, singles, stats

    def tau_from_tables(self, wlist, k: int) -> Optional[float]:
        """Valid lower bound on a query's k-th best total score from
        the per-term top-K0 tables: aggregate the real achievable
        partial scores per DISTINCT doc and take the k-th best."""
        if k > self.topk_k0:
            return None
        ds, ss = [], []
        for t, qw in wlist:
            tab = self.topk_dtw.get(int(t))
            if tab is None:
                continue
            dtw, d = tab
            kk = min(k, dtw.shape[0])
            ds.append(d[:kk].astype(np.int64))
            ss.append(np.float32(qw) * dtw[:kk])
        if not ds:
            return 0.0
        d = np.concatenate(ds)
        s = np.concatenate(ss).astype(np.float32)
        order = np.argsort(d, kind="stable")
        d, s = d[order], s[order]
        boundary = np.empty(d.shape[0], dtype=bool)
        boundary[0] = True
        boundary[1:] = d[1:] != d[:-1]
        per_doc = np.add.reduceat(s, np.flatnonzero(boundary))
        if per_doc.shape[0] < k:
            return 0.0
        return float(np.sort(per_doc)[::-1][k - 1])

    def answer_single(self, t: int, qw: float, k: int):
        """(scores desc, docids) of a one-term query from the table."""
        tab = self.topk_dtw.get(int(t))
        if tab is None:
            return (np.zeros(0, np.float32), np.zeros(0, np.int32))
        dtw, d = tab
        kk = min(k, dtw.shape[0])
        return (np.float32(qw) * dtw[:kk], d[:kk])

    def upload(self, buckets):
        """[(P, idxs, blk tensor, qw tensor, tmax)] on the store's device,
        in increasing P, and the metadata bytes uploaded."""
        out, nbytes = [], 0
        for P, (idxs, blk, qw, tmax) in sorted(buckets.items()):
            out.append((P, idxs, torch.from_numpy(blk).to(self.device),
                        torch.from_numpy(qw).to(self.device), tmax))
            nbytes += blk.nbytes + qw.nbytes
        return out, nbytes

    def serve(self, dev_buckets, k: int, shift: int = 0):
        """One pass over uploaded buckets: every bucket's K4 + sort-merge
        top-k is issued on the current stream, then the host waits once.
        Returns [(idxs, (R, k) scores, (R, k) docids)] as numpy."""
        res = [_bucket_topk(*block_copy(blk, qw, self._dstore, self._wstore),
                            P, k, tmax, shift)
               for P, _, blk, qw, tmax in dev_buckets]
        if not res:
            return []
        top = torch.cat([r[0] for r in res]).cpu().numpy()
        docs = torch.cat([r[1] for r in res]).cpu().numpy()
        out, r0 = [], 0
        for (_, idxs, _, _, _) in dev_buckets:
            out.append((idxs, top[r0:r0 + len(idxs)],
                        docs[r0:r0 + len(idxs)]))
            r0 += len(idxs)
        return out

    def ranked_topk(
        self,
        queries: Sequence[Sequence[int]],
        k: int = 10,
        prune: bool = True,
        lazy_cache=None,
    ) -> Tuple[List[np.ndarray], List[np.ndarray], Dict[str, int]]:
        """Exact ranked-union top-k per query (wand/maxscore/ranked_or
        all return this set).  Returns (scores desc, docids, stats).
        With ``prune`` and a lazy block cache, dead blocks are dropped
        first (see ``_batch_metadata``)."""
        buckets, singles, stats = self._batch_metadata(
            queries, k, prune=prune, lazy_cache=lazy_cache)
        out_s: List[np.ndarray] = [None] * len(queries)
        out_d: List[np.ndarray] = [None] * len(queries)
        for qi, (t, qw) in singles.items():
            out_s[qi], out_d[qi] = self.answer_single(t, qw, k)
        dev_buckets, upload = self.upload(buckets)
        for idxs, top, docs in self.serve(dev_buckets, k):
            for r, i in enumerate(idxs):
                keep = np.isfinite(top[r])
                out_s[i] = top[r][keep].astype(np.float32)
                out_d[i] = docs[r][keep]
        stats["upload_bytes"] = upload
        stats["store_bytes"] = self.store_bytes
        return out_s, out_d, stats
