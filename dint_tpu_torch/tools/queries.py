"""Query timing CLI (src/queries.cpp equivalent).

    python -m dint_tpu_torch.tools.queries <index_type>
        <query_type(colon-separated)> <index_file> [wand_data_file]
        --queries FILE [--runs R] [--k K] [--engine device|host|native]
        [--device cuda|cpu] [--device-ef]

<index_type> is any kind ``create_freq_index`` builds: the DINT family,
the EF family {ef, single, uniform, opt} and the block_<codec> kinds.

``--engine device`` (the default) runs whole batches on ``--device``.
For an index with 256-posting blocks (DINT and block_<codec>),
``ranked_or``, ``wand`` and ``maxscore`` go through the fused
device-resident store (``query/device_serve.py``: decode once at load,
K4 block copy + sort-merge top-k per pass); ``wand`` and ``maxscore``
first drop, with the Block-Max survival pass of ``query/bmw_device.py``,
the blocks that cannot reach a query's top-k (they need the wand data's
block-max sidecar and a lazy cache that decodes blocks in batches; the
three ops return the same top-k).  An EF-family index has no blocks:
its ranked ops take the row path of ``query/device_batch.py``,
unpruned, as in the reference (``--device-ef`` decodes a plain-EF
index's docid lists on ``--device``, ``codecs/ef_device.py``).  ``and``
and ``or`` count through the sort-merge engine of
``query/device_batch.py`` for every kind.

``--engine host`` runs one query at a time in numpy (``run_op``): and,
and_freq, or, or_freq, wand, maxscore, ranked_and over the skip-aware
lazy block cache, each query from a fresh cache so that its time covers
the blocks its skips land in; ranked_or over the pre-decoded lists.

Reports avg/q50/q90/q95 microseconds per query over R timed passes
after one untimed warm-up pass, one JSON line per op
(src/queries.cpp:25-61), with the device it ran on.

``--engine native`` runs the C++ cursor engine on the host
(``query/native_host.NativeQueryEngine``, every op of its ``OPS``) over
a DINT or block index, and over an EF-family index through the u32
block view that ``query/block_view.from_ef_index`` transcodes at load.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..backend import device_name, resolve_device
from ..index.dint_index import DintIndex
from ..query import bmw, bmw_device, boolean, device_batch, device_serve, ranked
from ..query.term_decode import TermDecoder
from . import common

ALL_TYPES = (sorted(common.DINT_KINDS) + list(common.EF_KINDS)
             + list(common.BLOCK_KINDS))
RANKED_DEVICE_OPS = ("wand", "maxscore", "ranked_or")
HOST_OPS = ("and", "and_freq", "or", "or_freq", "wand", "maxscore",
            "ranked_and", "ranked_or")


def percentiles(us):
    arr = np.sort(np.asarray(us))
    q = lambda p: float(arr[min(len(arr) - 1, int(p * len(arr)))])
    return {
        "avg": float(arr.mean()),
        "q50": q(0.5),
        "q90": q(0.9),
        "q95": q(0.95),
    }


def _timed_passes(one_pass, runs: int, Q: int):
    """One untimed warm-up pass, then ``runs`` timed passes; per-query
    microseconds of each (host clock around work that ends in a fetch of
    the results, so the card has finished) and the last pass's result."""
    out = one_pass()
    t_us = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = one_pass()
        t_us.append((time.perf_counter() - t0) * 1e6 / max(Q, 1))
    return t_us, out


def _batch_cache(decoder) -> bool:
    """The reference's gate for Block-Max pruning: the decoder's lazy
    cache decodes blocks in batches (DINT and block_<codec> indexes; the
    EF family's enumerator cache does not)."""
    return hasattr(getattr(decoder, "lazy_cache", None),
                   "docs_blocks_batch")


def load_index(index_type: str, path: str, device="cuda",
               device_ef: bool = False):
    """(index, decoder) of a saved index of any kind; the decoder serves
    on ``device`` (``device_ef``: a plain-EF index decodes its docid
    lists there too)."""
    if index_type in common.BLOCK_KINDS:
        from ..index.block_index import BlockIndex, BlockTermDecoder

        index = BlockIndex.load(path)
        return index, BlockTermDecoder(index, device=device)
    if index_type in common.EF_KINDS:
        from ..index.freq_index import EFTermDecoder, FreqIndexEF

        index = FreqIndexEF.load(path)
        return index, EFTermDecoder(index, device=device,
                                    device_ef=device_ef)
    index = DintIndex.load(path)
    return index, TermDecoder(index, device=device)


def native_engine(index_type: str, index, decoder, wdata):
    """The C++ cursor engine over ``index`` (an EF-family index through
    its u32 block view, transcoded at load by ``decoder``)."""
    from ..query.native_host import NativeQueryEngine

    if index_type in common.EF_KINDS:
        from ..query import block_view

        view = block_view.from_ef_index(index, decoder)
        common.log(f"EF block view transcode: {view.cold_start_s:.2f}s")
        return NativeQueryEngine(view, wdata)
    return NativeQueryEngine(index, wdata)


def run_op_native(engine, queries_list, op, runs, k):
    """One op through the native engine: ``runs`` timed passes after
    one untimed one; per-query microseconds and the result count."""
    t_us, cnt, _ = engine.run(op, queries_list, runs=runs + 1, k=k)
    return percentiles(t_us.ravel()), {"total_results": str(int(cnt.sum()))}


def run_op_device_fused(index, decoder, wdata, queries_list, op, runs, k,
                        store=None):
    """Fused device-resident serving: postings decode ONCE into the
    device block store at load (``store``, built over the log's terms
    when not given); each timed pass is K4 block copies + sort-merge
    top-k for every bucket, driven by 8 B of host metadata per shipped
    256-block, plus the single-term table lookups.  ``wand`` and
    ``maxscore`` ship only the blocks that pass the Block-Max survival
    test (given a block-max sidecar); ``prune_rows_host_s`` is the time
    of the batch metadata, that test included."""
    Q = len(queries_list)
    if store is None:
        terms = sorted({int(t) for q in queries_list for t in q})
        store = device_serve.DeviceServingStore(index, decoder, wdata,
                                                terms=terms)
    store_s = store.build_s
    common.log(f"[fused] store: {store.store_bytes >> 20} MiB, "
               f"built in {store_s:.1f} s")
    prune = (op in ("wand", "maxscore")
             and getattr(wdata, "block_maxw", None) is not None
             and _batch_cache(decoder))
    t1 = time.perf_counter()
    buckets, singles, stats = store._batch_metadata(
        queries_list, k, prune=prune,
        lazy_cache=decoder.lazy_cache if prune else None)
    meta_s = time.perf_counter() - t1
    dev_buckets, upload = store.upload(buckets)
    widest = max((P for P, *_ in dev_buckets), default=0)
    for P, idxs, blk, _, tmax in dev_buckets:
        common.log(f"[fused] bucket P={P} G={blk.shape[0]} rows={len(idxs)} "
                   f"tmax={tmax}")

    def one_pass():
        out = store.serve(dev_buckets, k)
        # single-term queries answer from the per-term top-k table —
        # part of each serving pass (host multiplies)
        sres = [store.answer_single(t, qw, k) for t, qw in singles.values()]
        return out, sres

    t_us, _ = _timed_passes(one_pass, runs, Q)
    extra = {
        "engine_variant": "fused-store",
        "single_term_queries": str(len(singles)),
        "store_bytes": str(store.store_bytes),
        "store_build_s": f"{store_s:.3f}",
        "prune_rows_host_s": f"{meta_s:.3f}",
        "row_upload_bytes": "0",
        "metadata_upload_bytes": str(upload),
        "blocks_kept": str(stats["blocks_kept"]),
        "blocks_total": str(stats["blocks_total"]),
        **{key: str(stats[key]) for key in
           ("device_queries", "host_fallback_queries", "event_width")
           if key in stats},
        "buckets": ",".join(f"{P}x{len(idxs)}"
                            for P, idxs, *_ in dev_buckets),
    }
    return percentiles(t_us), (Q, widest, len(dev_buckets)), extra


def run_op_device(index, decoder, wdata, queries_list, op, runs, k,
                  store=None, fused=True, prune_engine="device"):
    """Whole-batch device execution of one op on the decoder's device.
    Ranked ops (wand, maxscore, ranked_or) go through the fused store
    where the index has 256-posting blocks (``list_blocks``); with
    ``fused=False``, or over an EF-family index, they take the
    row-upload path: per-query
    (docid, score) rows are assembled on the host, for wand and maxscore
    from the blocks that survive Block-Max pruning where the decoder's
    lazy cache decodes blocks in batches (survival test on the
    device, or with ``prune_engine="host"`` in numpy), padded and
    uploaded once, and every timed pass sort-merges each bucket.  and/or
    count through the same sort-merge (rows padded and uploaded once;
    every timed pass runs each bucket and fetches its counts)."""
    if op in RANKED_DEVICE_OPS and fused and hasattr(index, "list_blocks"):
        return run_op_device_fused(index, decoder, wdata, queries_list, op,
                                   runs, k, store)
    Q = len(queries_list)
    dev = decoder.device
    extra = {}
    if op in ("and", "or"):
        drows, nterms = device_batch.build_boolean_rows(decoder, queries_list)
        srows = None
    elif op in RANKED_DEVICE_OPS:
        if (op != "ranked_or"
                and getattr(wdata, "block_maxw", None) is not None
                and _batch_cache(decoder)):
            # the decoder's memoizing cache is reused: row construction
            # is untimed, and a fresh cache would decode every surviving
            # block again
            t0 = time.perf_counter()
            if prune_engine == "device":
                drows, srows, pstats = bmw_device.build_pruned_rows_device(
                    decoder.lazy_cache, index, wdata, queries_list, k,
                    device=dev)
            else:
                drows, srows, pstats = bmw.build_pruned_rows(
                    decoder.lazy_cache, index, wdata, queries_list, k)
            extra = {
                "postings_kept": str(pstats["postings_kept"]),
                "postings_total": str(pstats["postings_total"]),
                "blocks_kept": str(pstats["blocks_kept"]),
                "blocks_total": str(pstats["blocks_total"]),
                "prune_rows_host_s": f"{time.perf_counter() - t0:.3f}",
                "prune_engine": prune_engine,
            }
        else:
            drows, srows = device_batch.build_ranked_rows(
                index, decoder, wdata, queries_list)
    else:
        raise ValueError(f"device engine does not support query type {op}")
    buckets, widest = [], 0
    for P, idxs in sorted(
        device_batch.bucket_queries([len(r) for r in drows]).items()
    ):
        d = device_batch.pad_batch([drows[i] for i in idxs],
                                   device_batch.PAD_DOC, np.int32)
        if srows is None:
            aux = nterms[idxs]
        else:
            aux = device_batch.pad_batch([srows[i] for i in idxs], 0.0,
                                         np.float32)
        buckets.append((torch.from_numpy(d).to(dev),
                        torch.from_numpy(aux).to(dev)))
        widest = max(widest, P)
    shape = (Q, widest, len(buckets))
    if srows is not None:
        def one_pass():
            return [tuple(x.cpu().numpy() for x in
                          device_batch.ranked_union_topk(d, s, k))
                    for d, s in buckets]

        t_us, _ = _timed_passes(one_pass, runs, Q)
        return percentiles(t_us), shape, extra
    pick = 0 if op == "and" else 1

    def one_pass():
        counts = [device_batch.boolean_counts(d, nt)[pick]
                  for d, nt in buckets]
        return torch.cat(counts).cpu().numpy() if counts else None

    t_us, total = _timed_passes(one_pass, runs, Q)
    return percentiles(t_us), shape, {
        "total_results": str(int(total.sum()) if total is not None else 0)}


def run_op(index, decoder, wdata, queries_list, op, runs, k):
    """Host engine.  Timings are DECODE-INCLUSIVE for the skip-aware
    ops (and/or/_freq via the lazy block engine, wand/maxscore via
    lazy cursors, ranked_and via the lazy AND): each query starts from
    a fresh block cache, so the reported latency covers exactly the
    block decodes the query's skips landed in — the reference's timed
    runs likewise decode blocks inside the enumerators
    (src/queries.cpp:15-61).  ranked_or is exhaustive by definition and
    keeps the pre-decoded warm cache (its decode, on the decoder's
    device, is the untimed warm-up, like the reference's index warm,
    queries.cpp:74-83).  An EF-family index's cursor cache has no block
    geometry (no ``docs_blocks_batch``), so there only wand and maxscore
    run lazily; and/or/_freq and ranked_and take the pre-decoded lists
    too, as in the reference.  The lazy ops leave the sums
    of their block and posting counters over the timed passes in
    ``decoder._lazy_totals``."""
    if op not in HOST_OPS:
        raise ValueError(f"unsupported query type {op}")
    cache_factory = type(decoder.lazy_cache)
    lazy = op != "ranked_or" and (op in ("wand", "maxscore")
                                  or _batch_cache(decoder))
    if not lazy:
        all_terms = sorted({int(t) for q in queries_list for t in q})
        decoder.decode_docids(all_terms)
        if op not in ("and", "or"):
            decoder.decode_freqs(all_terms)

    def one_query_lazy(q):
        cache = cache_factory(index)  # fresh: decode is timed per query
        t0 = time.perf_counter()
        if op in ("and", "and_freq"):
            res = boolean.and_query_lazy(cache, q)
            if op == "and_freq" and res.shape[0]:
                boolean.matched_freqs_lazy(cache, q, res)
        elif op in ("or", "or_freq"):
            res = boolean.or_query_lazy(cache, q)
            if op == "or_freq" and res.shape[0]:
                boolean.matched_freqs_lazy(cache, q, res)
        else:
            decoder._lazy_cache = cache  # fresh per query: decode included
            if op == "wand":
                ranked.wand(index, decoder, wdata, q, k)
            elif op == "ranked_and":
                ranked.ranked_and(index, decoder, wdata, q, k)
            else:
                ranked.maxscore(index, decoder, wdata, q, k)
        el = (time.perf_counter() - t0) * 1e6
        tot = decoder._lazy_totals
        if tot is not None:
            tot["docs_blocks"] += cache.docs_blocks_decoded
            tot["freqs_blocks"] += cache.freqs_blocks_decoded
            tot["postings_scored"] += cache.postings_scored
        return el

    def one_query_warm(q):
        t0 = time.perf_counter()
        if op == "ranked_and":
            ranked.ranked_and(index, decoder, wdata, q, k)
        elif op == "ranked_or":
            ranked.ranked_or(index, decoder, wdata, q, k)
        elif op in ("and", "and_freq"):
            boolean.and_query(decoder._doc_cache, boolean.dedup_terms(q))
        else:
            boolean.or_query(decoder._doc_cache, boolean.dedup_terms(q))
        return (time.perf_counter() - t0) * 1e6

    one_query = one_query_lazy if lazy else one_query_warm

    def one_pass():
        return [one_query(q) for q in queries_list]

    decoder._lazy_totals = None
    one_pass()  # untimed warmup run (queries.cpp:29-32 discards first)
    if lazy:
        # aggregated pruning counters across all timed queries
        decoder._lazy_totals = {
            "docs_blocks": 0, "freqs_blocks": 0, "postings_scored": 0,
        }
    t_us = []
    for _ in range(runs):
        t_us = one_pass()
    return percentiles(t_us)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("index_type", choices=ALL_TYPES)
    ap.add_argument("query_types")  # colon-separated
    ap.add_argument("index_file")
    ap.add_argument("wand_data_file", nargs="?")
    ap.add_argument("--queries", required=True)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument(
        "--engine", choices=["host", "native", "device"], default="device",
        help="device: whole-batch sort-merge passes on --device "
        "(query/device_serve.py, query/device_batch.py); host: per-query "
        "numpy engines over the lazy block cache; native: the C++ cursor "
        "engine on the host (query/native_host.py)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--device-ef", action="store_true",
                    help="ef kind: decode docid lists on --device "
                    "(codecs/ef_device.py)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    index, decoder = load_index(args.index_type, args.index_file, dev,
                                args.device_ef)
    wdata = (
        ranked.WandData.load(args.wand_data_file)
        if args.wand_data_file
        else None
    )
    queries_list = boolean.parse_query_log(args.queries)
    # drop queries naming unknown terms (reference relies on valid logs)
    queries_list = [
        q for q in queries_list if all(0 <= t < index.num_lists for t in q)
    ]
    native_eng = None
    if args.engine == "native":
        native_eng = native_engine(args.index_type, index, decoder, wdata)
        where = "the host (native engine)"
    else:
        where = device_name(dev)
    common.log(f"running {len(queries_list)} queries on {where}")
    records = []
    for op in args.query_types.split(":"):
        extra = {}
        if args.engine == "device":
            stats, shape, extra = run_op_device(
                index, decoder, wdata, queries_list, op, args.runs, args.k
            )
            extra = {"batch_shape": "x".join(map(str, shape)), **extra}
        elif args.engine == "native":
            stats, extra = run_op_native(native_eng, queries_list, op,
                                         args.runs, args.k)
        else:
            stats = run_op(
                index, decoder, wdata, queries_list, op, args.runs, args.k
            )
            if decoder._lazy_totals is not None:
                extra = {key: str(v)
                         for key, v in decoder._lazy_totals.items()}
        rec = {
            "type": op,
            "index": args.index_type,
            "engine": args.engine,
            "queries": str(len(queries_list)),
            "runs": str(args.runs),
            **{k: f"{v:.2f}" for k, v in stats.items()},
            **extra,
            "device": "host" if args.engine == "native" else device_name(dev),
        }
        common.stats_line(rec)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
