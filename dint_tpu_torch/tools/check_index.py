"""Standalone index verifier (src/check_index.cpp equivalent).

    python -m dint_tpu_torch.tools.check_index <index_type> <index_file>
        <collection_basename>

Covers every index family (DINT, EF-family, block-codec/mixed) with
verify_collection semantics: every docid and freq of every list
re-decoded on the host and compared to the input
(verify_collection.hpp:7-52); a mismatch exits non-zero.
"""

from __future__ import annotations

import argparse

from . import common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "index_type",
        choices=sorted(common.DINT_KINDS)
        + list(common.EF_KINDS)
        + list(common.BLOCK_KINDS),
    )
    ap.add_argument("index_file")
    ap.add_argument("collection_basename")
    args = ap.parse_args(argv)
    if args.index_type in common.EF_KINDS:
        from ..index import freq_index

        idx = freq_index.FreqIndexEF.load(args.index_file)
        freq_index.verify_freq_index(idx, args.collection_basename)
    elif args.index_type in common.BLOCK_KINDS:
        from ..index import block_index

        idx = block_index.BlockIndex.load(args.index_file)
        block_index.verify_block_index(idx, args.collection_basename)
    else:
        from ..index import dint_index

        idx = dint_index.DintIndex.load(args.index_file)
        dint_index.verify_index(idx, args.collection_basename)
    common.log("it's all good")


if __name__ == "__main__":
    main()
