"""Vroom-equivalent encoder CLI.

Usage (mirrors vroom_env/encode.cpp:269-329):

    python -m dint_tpu_torch.tools.encode <type> <collection_file>
        [--dict DICT_FILE] [--out OUT_FILE] [--cache-dir DIR]

<type> in {single_rect_dint, single_packed_dint, multi_packed_dint, ...}
(the DINT kinds; the other vroom codecs are not ported).
If --dict is absent the dictionary is trained (or loaded) with the
reference's create-or-load discipline.  Prints one JSON stats line
{filename, num_sequences, num_integers, type, GiB, bpi, ...} like
vroom_env/encode.cpp:38-58, plus the skip-sidecar size.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..codecs import encode_batch
from ..dictionary import builder as dict_builder
from ..dictionary.dictionary import (
    MultiPackedDictionary,
    PackedDictionary,
    RectangularDictionary,
)
from ..index import stream as stream_mod
from . import common


def load_or_train_dict(kind: str, policy, collection_file: str, dict_file, cache_dir):
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
    )


def encode_collection(
    type_name: str,
    collection_file: str,
    out_file: str,
    dict_file=None,
    cache_dir: str = ".",
):
    kind, policy = common.DINT_KINDS[type_name]
    d = load_or_train_dict(kind, policy, collection_file, dict_file, cache_dir)
    common.log("gap-transforming collection...")
    gap_lists, total_ints = common.gap_lists_of(collection_file)
    universes = [int(g.astype(np.int64).sum()) for g in gap_lists]
    ns = [len(g) for g in gap_lists]

    common.log(f"encoding {len(gap_lists)} lists ({total_ints} ints)...")
    if kind == "multi":
        streams, block_lens = encode_batch.encode_multi_lists(d, gap_lists)
    else:
        streams, block_lens = encode_batch.encode_single_lists(d, gap_lists)
    meta = stream_mod.write_stream(out_file, streams, ns, universes, block_lens)
    rec = stream_mod.stream_stats_line(type_name, out_file, meta)
    common.stats_line(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("type", choices=sorted(common.DINT_KINDS))
    ap.add_argument("collection_file")
    ap.add_argument("--dict", dest="dict_file")
    ap.add_argument("--out", dest="out_file")
    ap.add_argument("--cache-dir", default=".")
    args = ap.parse_args(argv)
    out = args.out_file or (args.collection_file + "." + args.type + ".bin")
    encode_collection(
        args.type, args.collection_file, out, args.dict_file, args.cache_dir
    )


if __name__ == "__main__":
    main()
