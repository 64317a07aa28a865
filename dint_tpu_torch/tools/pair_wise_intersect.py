"""Pairwise AND intersections with materialized results
(src/pair_wise_intersect.cpp equivalent: 2-term queries, results
materialized, microseconds per intersection, :28-120).

    python -m dint_tpu_torch.tools.pair_wise_intersect <index_type>
        <index_file> --queries FILE [--runs R] [--engine native|python]
        [--device cuda|cpu]

``native`` (the default for the DINT kinds) runs the ``and_collect``
op of ``query/native_host.NativeQueryEngine`` on the host: lazy
skip-aware cursors and materialized results, the reference tool's exact
loop; it raises with the build error when the native library does not
build.  ``python`` (the default for the EF and block kinds) decodes the
pairs' terms once (a DINT index through ``TermDecoder`` on ``--device``:
on the card, one fused class launch for the docids) and intersects the
decoded lists in numpy.  Returns the stats record it prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..index.dint_index import DintIndex
from ..query import boolean
from ..query.term_decode import TermDecoder
from . import common


def _pairs(path: str, num_lists: int):
    return [
        q for q in boolean.parse_query_log(path)
        if len(set(q)) == 2 and all(0 <= t < num_lists for t in q)
    ]


def _us_fields(arr: np.ndarray) -> dict:
    return {
        "avg_us": f"{arr.mean():.2f}" if arr.size else "0",
        "q50_us": f"{np.median(arr):.2f}" if arr.size else "0",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "index_type",
        choices=sorted(common.DINT_KINDS)
        + list(common.EF_KINDS)
        + list(common.BLOCK_KINDS),
    )
    ap.add_argument("index_file")
    ap.add_argument("--queries", required=True)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument(
        "--engine", choices=["native", "python"], default=None,
        help="native (default for DINT kinds): lazy skip-aware cursors + "
             "materialized results, the reference tool's exact loop; "
             "python: pre-decoded numpy intersection (the oracle path)")
    ap.add_argument("--device", default="cuda",
                    help="where the python engine decodes (cuda or cpu)")
    args = ap.parse_args(argv)

    engine = args.engine
    if engine is None:
        engine = "native" if args.index_type in common.DINT_KINDS else "python"

    if engine == "native":
        if args.index_type not in common.DINT_KINDS:
            ap.error("--engine native takes a DINT index kind")
        from ..query.native_host import NativeQueryEngine

        index = DintIndex.load(args.index_file)
        pairs = _pairs(args.queries, index.num_lists)
        common.log(f"running {len(pairs)} pairwise intersections (native)")
        eng = NativeQueryEngine(index)
        # reference protocol (src/pair_wise_intersect.cpp:86-107):
        # 10+1 runs, first untimed, per-intersection avg over the rest
        runs = max(args.runs, 2)
        times_us, counts, _ = eng.run("and_collect", pairs, runs=runs)
        rec = {
            "type": "pair_wise_intersect",
            "engine": "native",
            "index": args.index_type,
            "pairs": str(len(pairs)),
            "runs": str(runs),
            "total_results": str(int(counts.sum())),
            **_us_fields(times_us.reshape(-1)),
        }
        common.stats_line(rec)
        return rec

    if args.index_type in common.EF_KINDS:
        from ..index.freq_index import EFTermDecoder, FreqIndexEF

        index = FreqIndexEF.load(args.index_file)
        decoder = EFTermDecoder(index, device=args.device)
    elif args.index_type in common.BLOCK_KINDS:
        from ..index.block_index import BlockIndex, BlockTermDecoder

        index = BlockIndex.load(args.index_file)
        decoder = BlockTermDecoder(index, device=args.device)
    else:
        index = DintIndex.load(args.index_file)
        decoder = TermDecoder(index, device=args.device)

    pairs = _pairs(args.queries, index.num_lists)
    common.log(f"running {len(pairs)} pairwise intersections")
    all_terms = sorted({int(t) for q in pairs for t in q})
    decoded = decoder.decode_docids(all_terms)

    total_results = 0
    timings = []
    for _ in range(args.runs):
        t_us = []
        total_results = 0
        for q in pairs:
            t0 = time.perf_counter()
            res = boolean.and_query(decoded, q)  # materialized result set
            total_results += int(res.shape[0])
            t_us.append((time.perf_counter() - t0) * 1e6)
        timings = t_us
    rec = {
        "type": "pair_wise_intersect",
        "index": args.index_type,
        "pairs": str(len(pairs)),
        "total_results": str(total_results),
        **_us_fields(np.asarray(timings)),
    }
    common.stats_line(rec)
    return rec


if __name__ == "__main__":
    main()
