"""Index-building CLI (src/create_freq_index.cpp equivalent).

    python -m dint_tpu_torch.tools.create_freq_index <index_type>
        <collection_basename> [output_filename] [--check] [--cache-dir DIR]
        [--shards N]

<index_type> is one of the DINT family (single_rect_dint,
single_packed_dint, multi_packed_dint, ...).  Builds the index (training
or loading dictionaries with the reference's create-or-load discipline),
prints the bpi stats line (index_build_utils.hpp:91-118 analogue), saves
it in the reference package's file format, and with --check re-decodes
every posting against the input (verify_collection.hpp).  ``--shards N``
builds the list space in N spawned worker processes
(``parallel/build.build_index_sharded``), the same index as the serial
build.

The EF family (ef, single, uniform, opt) and the block_<codec> kinds are
not ported yet: ROADMAP.md 'Modules still to port' item 4.
"""

from __future__ import annotations

import argparse

from ..index import dint_index
from . import common

# the reference's other index families (index_types.hpp:25-80)
EF_KINDS = ("ef", "single", "uniform", "opt")
BLOCK_KINDS = tuple(
    "block_" + c
    for c in (
        "optpfor", "varintg8iu", "interpolative", "qmx", "mixed", "u32",
        "vbyte", "simple16", "varintgb", "maskedvbyte", "streamvbyte",
    )
)
NOT_PORTED = ("ROADMAP.md 'Modules still to port' item 4 (the EF and "
              "block_<codec> index families)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("index_type",
                    choices=sorted(common.DINT_KINDS) + list(EF_KINDS)
                    + list(BLOCK_KINDS))
    ap.add_argument("collection_basename")
    ap.add_argument("output_filename", nargs="?")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--cache-dir", default=".")
    ap.add_argument(
        "--shards", type=int, default=0, metavar="N",
        help="DINT types: shard the list space over N worker processes "
        "(parallel prepare, ordered commit — identical output to the "
        "serial build)",
    )
    args = ap.parse_args(argv)
    if args.index_type not in common.DINT_KINDS:
        raise NotImplementedError(
            f"index type {args.index_type!r} is not ported yet: {NOT_PORTED}")
    kind, policy = common.DINT_KINDS[args.index_type]
    if args.shards > 1:
        from ..parallel import build as pbuild

        idx = pbuild.build_index_sharded(
            args.collection_basename, kind, policy or "pack",
            args.cache_dir, n_workers=args.shards,
        )
    else:
        idx = dint_index.build_index(args.collection_basename, kind,
                                     policy or "pack", args.cache_dir)
    stats = idx.size_stats()
    common.stats_line({"type": args.index_type, **stats})
    if args.output_filename:
        common.log(f"saving index to {args.output_filename}...")
        idx.save(args.output_filename)
    if args.check:
        common.log("verifying index against collection...")
        dint_index.verify_index(idx, args.collection_basename)
        common.log("it's all good")
    return idx


if __name__ == "__main__":
    main()
