"""Per-term per-block access profiler (host copy; block_profiler.hpp rebuild).

The reference hooks a compile-time Profile flag into
block_posting_list (block_posting_list.hpp:96-99,316-330) and dumps a
TSV of per-term per-block docs/freqs decode counts (:27-54).  Here the
profiler is a process-global registry the term decoders update when
enabled; counts feed the mixed-block access-weighted selection
(mixed_block.hpp:142-144).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_enabled = False
_counts: Dict[int, np.ndarray] = {}  # term -> (2, num_blocks) [docs, freqs]


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    _counts.clear()


def open_list(term: int, num_blocks: int) -> None:
    if term not in _counts:
        _counts[term] = np.zeros((2, num_blocks), dtype=np.int64)


def count_docs(term: int, block_in_list: int, k: int = 1) -> None:
    if _enabled and term in _counts:
        _counts[term][0, block_in_list] += k


def count_freqs(term: int, block_in_list: int, k: int = 1) -> None:
    if _enabled and term in _counts:
        _counts[term][1, block_in_list] += k


def counts_for(term: int) -> Optional[np.ndarray]:
    return _counts.get(term)


def dump(path: str) -> None:
    """TSV: term <tab> docs-counts... / term <tab> freqs-counts...
    (block_profiler.hpp:37-52 layout spirit)."""
    with open(path, "w") as f:
        f.write("block_access_counts\n")
        for term in sorted(_counts):
            c = _counts[term]
            f.write(f"d {term}\t" + "\t".join(map(str, c[0])) + "\n")
            f.write(f"f {term}\t" + "\t".join(map(str, c[1])) + "\n")


def load(path: str) -> Dict[int, np.ndarray]:
    out: Dict[int, np.ndarray] = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            tag, rest = line.split(" ", 1)
            term_s, *vals = rest.rstrip("\n").split("\t")
            term = int(term_s)
            arr = np.asarray([int(v) for v in vals], dtype=np.int64)
            if term not in out:
                out[term] = np.zeros((2, arr.shape[0]), dtype=np.int64)
            out[term][0 if tag == "d" else 1] = arr
    return out
