"""Consistency checker (vroom_env/check_encoded_data.cpp equivalent).

Decodes an encoded stream and compares every integer against the
gap-transformed source collection; exits non-zero on the first
mismatch, like the reference (:20-120).

    python -m dint_tpu_torch.tools.check_encoded_data <type>
        <encoded_file> <collection_file> [--dict DICT_FILE]
        [--device cuda|cpu]

A DINT type decodes through ``decode.decode_stream`` (engine ``local``,
one run: on the card, one fused class launch over the stream's image);
a zoo type through the host decoder ``decode.decode_zoo``.
"""

from __future__ import annotations

import argparse

from . import common, decode


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "type", choices=sorted(common.DINT_KINDS) + list(common.VROOM_ZOO)
    )
    ap.add_argument("encoded_file")
    ap.add_argument("collection_file")
    ap.add_argument("--dict", dest="dict_file")
    ap.add_argument("--device", default="cuda",
                    help="where a DINT stream decodes (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.type in common.VROOM_ZOO:
        rec = decode.decode_zoo(
            args.type, args.encoded_file, 1, args.collection_file
        )
    else:
        rec = decode.decode_stream(
            args.type,
            args.encoded_file,
            args.dict_file,
            runs=1,
            check_collection=args.collection_file,
            device=args.device,
        )
    common.log("everything's good")
    return rec


if __name__ == "__main__":
    main()
