"""Dictionary-copy microbenchmark (src/dict_perf_test.cpp equivalent).

Times random dictionary `copy` operations and reports ns/copy over N
random indices (:32-63 does 10M random copies on a rectangular
dictionary, 10 runs).  Two engines, both on the host:

  * native (default): the serving path, one 16-word memcpy + length
    read per copy over the fused row layout, the exact loop of the
    reference tool (query/native_host.py dict_copy_ns over
    native/query_host.cpp qh_dict_copy); it raises with the build error
    when the native library does not build.
  * numpy: the batched-gather formulation (chunked reused buffers),
    with a checksum of the first word of every copied row.

The indices come from a generator seeded with 13, so the same
dictionary gives the same draw (and the same numpy checksum) in every
run.

    python -m dint_tpu_torch.tools.dict_perf_test <dict_file> <kind>
        [--copies N] [--runs R] [--engine native|numpy]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import MAX_ENTRY_SIZE, NUM_ENTRIES, RESERVED
from ..dictionary.dictionary import (
    MultiPackedDictionary,
    PackedDictionary,
    RectangularDictionary,
)
from . import common


def sample_indices(d, view, kind: str, copies: int, rng) -> np.ndarray:
    """Random (context, entry) sample as GLOBAL row indices
    (ctx * NUM_ENTRIES + entry), matching the decode access pattern."""
    if kind == "rectangular":
        return rng.integers(
            RESERVED, max(d.m_size, RESERVED + 1), copies
        ).astype(np.uint32)
    if kind == "multi":
        # sample across ALL selector classes with per-class valid
        # counts (context 0 alone holds only the handful of longest-run
        # codewords).  Contexts with counts <= RESERVED hold run
        # constants only — no decodable non-reserved entries — so they
        # are excluded from the draw rather than clamped onto the
        # zero-fill region.
        counts = np.array(
            [min(d.context_count(c), NUM_ENTRIES)
             for c in range(view.offsets.shape[0])], np.int64)
        valid = np.flatnonzero(counts > RESERVED)
        assert valid.size, "no context has non-reserved entries"
        ctx = valid[rng.integers(0, valid.size, copies)]
        ent = RESERVED + (
            rng.integers(0, 1 << 30, copies)
            % (counts[ctx] - RESERVED))
        return (ctx * NUM_ENTRIES + ent).astype(np.uint32)
    return rng.integers(
        RESERVED, max(d.size, RESERVED + 1), copies
    ).astype(np.uint32)



def numpy_copies(view, gidx_all: np.ndarray):
    """The numpy engine's timed loop: resolve offsets, then gather
    16-wide rows, chunked into reused pre-touched buffers (the reference
    copies into one fixed 16-word target, so fresh multi-hundred-MB
    arrays would time page faults, not the copies; offset resolution
    stays inside the timed region like the reference's `offset(i)`
    call).  Returns (seconds, checksum of each row's first word)."""
    copies = gidx_all.shape[0]
    chunk = 1_000_000
    buf = np.zeros((chunk, MAX_ENTRY_SIZE), np.uint32)
    gidx = np.zeros((chunk, MAX_ENTRY_SIZE), np.int64)
    flat = np.zeros(copies, np.int64)
    ar = np.arange(MAX_ENTRY_SIZE, dtype=np.int64)[None, :]
    ctx_i = (gidx_all // NUM_ENTRIES).astype(np.int64)
    ent_i = (gidx_all % NUM_ENTRIES).astype(np.int64)
    checksum = 0
    t0 = time.perf_counter()
    np.copyto(flat, view.offsets[ctx_i, ent_i].astype(np.int64))
    for s in range(0, copies, chunk):
        f = flat[s : s + chunk]
        m = f.shape[0]
        np.add(f[:, None], ar, out=gidx[:m])
        np.take(view.table, gidx[:m], out=buf[:m])
        checksum += int(buf[:m, 0].astype(np.int64).sum())
    return time.perf_counter() - t0, checksum


def load(dict_file: str, kind: str):
    if kind == "rectangular":
        return RectangularDictionary.load(dict_file)
    if kind == "multi":
        return MultiPackedDictionary.load(dict_file)
    return PackedDictionary.load(dict_file)


def main(argv=None):
    """Runs the benchmark; returns the stats record it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("dict_file")
    ap.add_argument("kind", choices=["rectangular", "single", "multi"])
    ap.add_argument("--copies", type=int, default=10_000_000)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--engine", choices=["native", "numpy"],
                    default="native")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(13)
    d = load(args.dict_file, args.kind)
    view = d.decode_view()
    gidx_all = sample_indices(d, view, args.kind, args.copies, rng)

    if args.engine == "native":
        from ..query import native_host

        ns = native_host.dict_copy_ns(view, gidx_all, runs=args.runs)
        rec = {
            "type": f"dict_copy_{args.kind}",
            "engine": "native",
            "copies": str(args.copies),
            "runs": str(args.runs),
            "ns_per_copy": f"{ns:.3f}",
        }
    else:
        secs, checksum = numpy_copies(view, gidx_all)
        rec = {
            "type": f"dict_copy_{args.kind}",
            "engine": "numpy",
            "copies": str(args.copies),
            "ns_per_copy": f"{secs * 1e9 / args.copies:.3f}",
            "checksum": str(checksum),
        }
    common.stats_line(rec)
    return rec


if __name__ == "__main__":
    main()
