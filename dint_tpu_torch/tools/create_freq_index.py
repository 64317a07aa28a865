"""Index-building CLI (src/create_freq_index.cpp equivalent).

    python -m dint_tpu_torch.tools.create_freq_index <index_type>
        <collection_basename> [output_filename] [--check] [--cache-dir DIR]
        [--shards N]

<index_type> covers every family of the reference (index_types.hpp:
25-80): the DINT family (single_rect_dint, single_packed_dint,
multi_packed_dint, ...), the EF family {ef, single, uniform, opt} and
the block_<codec> kinds (block_mixed included).  Builds the index
(training or loading dictionaries with the reference's create-or-load
discipline for DINT types),
prints the bpi stats line (index_build_utils.hpp:91-118 analogue), saves
it in the reference package's file format, and with --check re-decodes
every posting against the input (verify_collection.hpp).  ``--shards N``
builds the list space in N spawned worker processes
(``parallel/build.build_index_sharded``), the same index as the serial
build.
"""

from __future__ import annotations

import argparse

from ..index import dint_index, freq_index
from . import common

ALL_TYPES = (sorted(common.DINT_KINDS) + list(common.EF_KINDS)
             + list(common.BLOCK_KINDS))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("index_type", choices=ALL_TYPES)
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

    if args.index_type in common.BLOCK_KINDS:
        from ..index import block_index

        codec = common.block_codec_of(args.index_type)
        if codec == "mixed":
            from ..index import mixed_block

            idx = mixed_block.build_mixed_index(args.collection_basename)
        else:
            idx = block_index.build_block_index(args.collection_basename,
                                                codec)
        stats = idx.size_stats()
        common.stats_line({"type": args.index_type, **stats})
        if args.output_filename:
            idx.save(args.output_filename)
        if args.check:
            common.log("verifying index against collection...")
            block_index.verify_block_index(idx, args.collection_basename)
            common.log("it's all good")
        return idx

    if args.index_type in common.EF_KINDS:
        idx = freq_index.build_freq_index(args.collection_basename,
                                          args.index_type)
        stats = idx.size_stats()
        common.stats_line({"type": args.index_type, **stats})
        if args.output_filename:
            idx.save(args.output_filename)
        if args.check:
            common.log("verifying index against collection...")
            freq_index.verify_freq_index(idx, args.collection_basename)
            common.log("it's all good")
        return idx

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
