"""Query timing CLI on the card (src/queries.cpp equivalent).

    python -m dint_tpu_torch.tools.queries <index_type>
        <query_type(colon-separated)> <index_file> [wand_data_file]
        --queries FILE [--runs R] [--k K] [--engine device]
        [--device cuda|cpu]

The device engine (the only one ported): ``ranked_or`` goes through the
fused device-resident store (``query/device_serve.py``: decode once at
load, K4 block copy + sort-merge top-k per pass); ``and`` and ``or``
count through the sort-merge engine of ``query/device_batch.py``.
Reports avg/q50/q90/q95 microseconds per query over R timed passes of
the whole batch after one untimed warm-up pass, one JSON line per op
(src/queries.cpp:25-61), with the device it ran on.

Not ported yet: ``wand`` and ``maxscore`` (the reference prunes them
with Block-Max WAND on the device engine) and ``--engine host`` (ROADMAP
item 1, the BMW slice); ``--engine native`` (ROADMAP item 5).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..backend import device_name, resolve_device
from ..index.dint_index import DintIndex
from ..query import boolean, device_batch, device_serve, ranked
from ..query.term_decode import TermDecoder
from . import common

NOT_PORTED_ENGINES = {
    "host": "ROADMAP.md 'Modules still to port' item 1 (the BMW slice: "
            "lazy cursors and the host query engines)",
    "native": "ROADMAP.md 'Modules still to port' item 5 (the native C++ "
              "cursor engine, query/native_host.py)",
}
NOT_PORTED_OPS = {
    "wand": device_serve.NOT_PORTED_PRUNE,
    "maxscore": device_serve.NOT_PORTED_PRUNE,
}


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


def run_op_device_fused(index, decoder, wdata, queries_list, op, runs, k,
                        store=None):
    """Fused device-resident serving: postings decode ONCE into the
    device block store at load (``store``, built over the log's terms
    when not given); each timed pass is K4 block copies + sort-merge
    top-k for every bucket, driven by 8 B of host metadata per touched
    256-block, plus the single-term table lookups."""
    Q = len(queries_list)
    if store is None:
        terms = sorted({int(t) for q in queries_list for t in q})
        store = device_serve.DeviceServingStore(index, decoder, wdata,
                                                terms=terms)
    store_s = store.build_s
    common.log(f"[fused] store: {store.store_bytes >> 20} MiB, "
               f"built in {store_s:.1f} s")
    t1 = time.perf_counter()
    buckets, singles, stats = store._batch_metadata(queries_list, k)
    dev_buckets, upload = store.upload(buckets)
    meta_s = time.perf_counter() - t1
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
        "blocks": str(stats["blocks"]),
        "buckets": ",".join(f"{P}x{len(idxs)}"
                            for P, idxs, *_ in dev_buckets),
    }
    return percentiles(t_us), (Q, widest, len(dev_buckets)), extra


def run_op_device(index, decoder, wdata, queries_list, op, runs, k,
                  store=None):
    """Whole-batch device execution of one op: ranked_or through the
    fused store, and/or through the sort-merge counts of device_batch
    (rows padded and uploaded once; every timed pass runs each bucket
    and fetches its counts)."""
    if op in NOT_PORTED_OPS:
        raise NotImplementedError(
            f"query type {op!r} is not ported yet: {NOT_PORTED_OPS[op]}")
    if op == "ranked_or":
        return run_op_device_fused(index, decoder, wdata, queries_list, op,
                                   runs, k, store)
    if op not in ("and", "or"):
        raise ValueError(f"device engine does not support query type {op}")
    Q = len(queries_list)
    drows, nterms = device_batch.build_boolean_rows(decoder, queries_list)
    buckets, widest = [], 0
    for P, idxs in sorted(
        device_batch.bucket_queries([len(r) for r in drows]).items()
    ):
        d = device_batch.pad_batch([drows[i] for i in idxs],
                                   device_batch.PAD_DOC, np.int32)
        buckets.append((torch.from_numpy(d).to(decoder.device),
                        torch.from_numpy(nterms[idxs]).to(decoder.device)))
        widest = max(widest, P)
    pick = 0 if op == "and" else 1

    def one_pass():
        counts = [device_batch.boolean_counts(d, nt)[pick]
                  for d, nt in buckets]
        return torch.cat(counts).cpu().numpy() if counts else None

    t_us, total = _timed_passes(one_pass, runs, Q)
    return percentiles(t_us), (Q, widest, len(buckets)), {
        "total_results": str(int(total.sum()) if total is not None else 0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("index_type", choices=sorted(common.DINT_KINDS))
    ap.add_argument("query_types")  # colon-separated
    ap.add_argument("index_file")
    ap.add_argument("wand_data_file", nargs="?")
    ap.add_argument("--queries", required=True)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument(
        "--engine", choices=["host", "native", "device"], default="device",
        help="device (whole-batch sort-merge on the card; the only engine "
        "ported so far)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.engine in NOT_PORTED_ENGINES:
        raise NotImplementedError(
            f"engine {args.engine!r} is not ported yet: "
            f"{NOT_PORTED_ENGINES[args.engine]}")
    dev = resolve_device(args.device)
    index = DintIndex.load(args.index_file)
    decoder = TermDecoder(index, device=dev)
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
    common.log(f"running {len(queries_list)} queries on {device_name(dev)}")
    records = []
    for op in args.query_types.split(":"):
        stats, shape, extra = run_op_device(
            index, decoder, wdata, queries_list, op, args.runs, args.k
        )
        rec = {
            "type": op,
            "index": args.index_type,
            "engine": args.engine,
            "queries": str(len(queries_list)),
            "runs": str(args.runs),
            **{k: f"{v:.2f}" for k, v in stats.items()},
            "batch_shape": "x".join(map(str, shape)),
            **extra,
            "device": device_name(dev),
        }
        common.stats_line(rec)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
