"""Shared helpers for the vroom-style CLI tools.

Mirrors the reference drivers' behavior: gap transform chosen by file
extension (vroom_env/encode.cpp:70-110), single-line JSON stats records
on stdout (vroom_env/statistics.hpp:7-34), timestamped log lines on
stderr (util.hpp:76-84).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Iterator, List, Tuple

import numpy as np

from ..io.collection import BinaryCollection
from ..utils import gaps as gap_mod

DINT_KINDS = {
    "single_rect_dint": ("rectangular", None),
    "single_packed_dint": ("single", "pack"),
    "single_overlapped_dint": ("single", "overlap"),
    "multi_packed_dint": ("multi", "pack"),
    "multi_overlapped_dint": ("multi", "overlap"),
}

EF_KINDS = ("ef", "single", "uniform", "opt")

# block_freq_index family (index_types.hpp:39-49): block_<codec>
BLOCK_KINDS = tuple(
    "block_" + c
    for c in (
        "optpfor", "varintg8iu", "interpolative", "qmx", "mixed", "u32",
        "vbyte", "simple16", "varintgb", "maskedvbyte", "streamvbyte",
    )
)


def block_codec_of(index_type: str) -> str:
    assert index_type.startswith("block_")
    return index_type[len("block_"):]

# vroom whole-list codec types (vroom_env/codecs.hpp CODECS :511-513 + pef)
VROOM_ZOO = (
    "u32", "vbyte", "streamvbyte", "maskedvbyte", "varintgb", "qmx",
    "simple16", "optpfor", "varintg8iu", "interpolative", "pef",
)


def log(msg: str) -> None:
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"{ts}: {msg}", file=sys.stderr, flush=True)


def stats_line(record: dict) -> None:
    print(json.dumps(record), flush=True)


def is_docs_file(path: str) -> bool:
    if path.endswith(".docs"):
        return True
    if path.endswith(".freqs"):
        return False
    raise ValueError("unsupported file format (need .docs or .freqs)")


def gap_lists_of(path: str) -> Tuple[List[np.ndarray], int]:
    """Gap-transformed lists of a collection file + total int count."""
    docs = is_docs_file(path)
    coll = BinaryCollection(path)
    from ..stats import native_stats

    got = native_stats.collection_gap_arrays(coll, docs)
    if got is not None:  # one native pass instead of per-list python
        flat, offs = got
        out = [
            flat[offs[i] : offs[i + 1]]
            for i in range(offs.shape[0] - 1)
            if offs[i + 1] > offs[i]
        ]
        return out, int(flat.shape[0])
    out: List[np.ndarray] = []
    start = 1 if docs else 0
    for i in range(start, len(coll)):
        seq = coll.sequence(i)
        if seq.shape[0] == 0:
            continue
        out.append(
            gap_mod.docs_to_gaps(seq) if docs else gap_mod.freqs_to_gaps(seq)
        )
    return out, int(sum(len(g) for g in out))
