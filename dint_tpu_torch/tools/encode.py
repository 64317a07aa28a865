"""Vroom-equivalent encoder CLI.

Usage (mirrors vroom_env/encode.cpp:269-329):

    python -m dint_tpu_torch.tools.encode <type> <collection_file>
        [--dict DICT_FILE] [--out OUT_FILE] [--cache-dir DIR]

<type> in {single_rect_dint, single_packed_dint, multi_packed_dint, ...}
or one of the vroom zoo codecs (u32, vbyte, ..., pef; whole lists, no
dictionary).
For a DINT type, if --dict is absent the dictionary is trained (or loaded) with the
reference's create-or-load discipline.  Prints one JSON stats line
{filename, num_sequences, num_integers, type, GiB, bpi, ...} like
vroom_env/encode.cpp:38-58, plus the skip-sidecar size.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..codecs import encode_batch
from ..dictionary import builder as dict_builder
from ..dictionary.dictionary import (
    MultiPackedDictionary,
    PackedDictionary,
    RectangularDictionary,
)
from ..index import stream as stream_mod
from ..utils import trace
from . import common


def load_or_train_dict(kind: str, policy, collection_file: str, dict_file,
                       cache_dir, device="cuda"):
    if dict_file and os.path.exists(dict_file):
        if kind == "rectangular":
            return RectangularDictionary.load(dict_file)
        if kind == "multi":
            return MultiPackedDictionary.load(dict_file, policy or "pack")
        return PackedDictionary.load(dict_file, policy or "pack")
    common.log("building or loading dictionary (create-or-load)...")
    return dict_builder.build_or_load_dict(
        collection_file,
        common.is_docs_file(collection_file),
        kind,
        policy or "pack",
        cache_dir=cache_dir,
        device=device,
    )


def encode_collection(
    type_name: str,
    collection_file: str,
    out_file: str,
    dict_file=None,
    cache_dir: str = ".",
    device="cuda",
):
    """Encode a collection file as ``type_name``; a dictionary not given
    is trained (the collectors' merges, where they run, on ``device``)
    or loaded from ``cache_dir``.  Prints and returns the stats line.
    The gap transform, the encoding and the write are the span
    ``build.encode``."""
    kind, policy = common.DINT_KINDS[type_name]
    d = load_or_train_dict(kind, policy, collection_file, dict_file,
                           cache_dir, device)
    with trace.span("build.encode"):
        common.log("gap-transforming collection...")
        gap_lists, total_ints = common.gap_lists_of(collection_file)
        universes = [int(g.astype(np.int64).sum()) for g in gap_lists]
        ns = [len(g) for g in gap_lists]

        common.log(f"encoding {len(gap_lists)} lists ({total_ints} ints)...")
        if kind == "multi":
            streams, block_lens = encode_batch.encode_multi_lists(
                d, gap_lists)
        else:
            streams, block_lens = encode_batch.encode_single_lists(
                d, gap_lists)
        meta = stream_mod.write_stream(out_file, streams, ns, universes,
                                       block_lens)
    rec = stream_mod.stream_stats_line(type_name, out_file, meta)
    common.stats_line(rec)
    return rec


def _encode_zoo_list(args):
    """(payload, chunk byte lengths, universe) of one list: gaps for the
    zoo codecs, the docID sequence for pef."""
    from ..index import vroom_zoo
    from ..utils import gaps as gap_mod

    type_name, g = args
    if type_name == "pef":
        # pef codes the docID sequence itself (prefix sums of gaps+1)
        d = gap_mod.gaps_to_docs(g)
        body, _bits = vroom_zoo.encode_list_pef(d)
        return body, [len(body)], int(d[-1]) + 1
    body, lens = vroom_zoo.encode_list_zoo(type_name, g)
    return body, lens, int(g.astype(np.int64).sum())


def encode_zoo(type_name: str, collection_file: str, out_file: str,
               workers: int = 1):
    """Whole-list encoding for the non-DINT vroom types (incl. pef).
    ``workers`` > 1 encodes the lists in that many processes, longest
    lists first; the stream is the same bytes either way.  The workers
    start from a fork server, not from a fork of this process, whose
    threads (a framework's thread pools) a fork would copy stopped."""
    return encode_zoo_many({type_name: out_file}, collection_file,
                           workers)[type_name]


def encode_zoo_many(out_files: dict, collection_file: str, workers: int = 1):
    """``encode_zoo`` for several types at once ({type: out file}): one
    gap transform and, with ``workers`` > 1, one process pool over the
    lists of every type, longest lists first.  Returns {type: stats
    record}."""
    gap_lists, _ = common.gap_lists_of(collection_file)
    ns = [len(g) for g in gap_lists]
    jobs = [(t, g) for t in out_files for g in gap_lists]
    if workers > 1 and len(jobs) > 1:
        order = sorted(range(len(jobs)), key=lambda i: -ns[i % len(ns)])
        ctx = multiprocessing.get_context("forkserver")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            got = list(ex.map(_encode_zoo_list, [jobs[i] for i in order]))
        res = [None] * len(jobs)
        for i, r in zip(order, got):
            res[i] = r
    else:
        res = [_encode_zoo_list(j) for j in jobs]
    recs = {}
    for k, (type_name, out_file) in enumerate(out_files.items()):
        mine = res[k * len(ns):(k + 1) * len(ns)]
        meta = stream_mod.write_stream(
            out_file, [r[0] for r in mine], ns, [r[2] for r in mine],
            [r[1] for r in mine])
        recs[type_name] = stream_mod.stream_stats_line(type_name, out_file,
                                                       meta)
        common.stats_line(recs[type_name])
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "type", choices=sorted(common.DINT_KINDS) + list(common.VROOM_ZOO)
    )
    ap.add_argument("collection_file")
    ap.add_argument("--dict", dest="dict_file")
    ap.add_argument("--out", dest="out_file")
    ap.add_argument("--cache-dir", default=".")
    args = ap.parse_args(argv)
    out = args.out_file or (args.collection_file + "." + args.type + ".bin")
    if args.type in common.VROOM_ZOO:
        encode_zoo(args.type, args.collection_file, out)
    else:
        encode_collection(
            args.type, args.collection_file, out, args.dict_file,
            args.cache_dir
        )


if __name__ == "__main__":
    main()
