"""wand_data CLI (src/create_wand_data.cpp equivalent).

    python -m dint_tpu_torch.tools.create_wand_data <collection_basename> <output>

Reads ``<basename>.docs``, ``.freqs`` and ``.sizes`` and writes the
reference package's ``.npz`` wand data (with the per-block maxima).
"""

from __future__ import annotations

import argparse

from ..query import ranked
from . import common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("collection_basename")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    common.log("building wand data...")
    w = ranked.build_wand_data(args.collection_basename)
    w.save(args.output)
    common.log(f"saved {args.output}")
    return w


if __name__ == "__main__":
    main()
