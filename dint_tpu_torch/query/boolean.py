"""Boolean query processing — and_query / or_query equivalents.

The port's copy of the host part of ``dint_tpu/query/boolean.py``.
Reference semantics (queries.hpp:34-130): AND deduplicates terms, sorts
lists by size and keeps the candidates found in every larger list; OR is
the sorted union.  Result docID sets are exact.  The skip-aware
``*_lazy`` forms walk the lazy block decoder and are not ported yet:
ROADMAP.md 'Modules still to port' item 1 (the BMW slice).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def parse_query_log(path: str) -> List[List[int]]:
    """read_query format (queries.hpp:15-27): whitespace term ids per line."""
    out: List[List[int]] = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                out.append([int(t) for t in toks])
    return out


def dedup_terms(terms: Sequence[int]) -> List[int]:
    """remove_duplicate_terms (queries.hpp:29-32): sort + unique."""
    return sorted(set(int(t) for t in terms))


def and_query(decoded: Dict[int, np.ndarray], terms: Sequence[int]) -> np.ndarray:
    """Exact AND result docIDs."""
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    lists = sorted((decoded[t] for t in terms), key=len)
    cand = lists[0]
    for arr in lists[1:]:
        if cand.shape[0] == 0:
            break
        pos = np.searchsorted(arr, cand)
        ok = pos < arr.shape[0]
        ok[ok] = arr[pos[ok]] == cand[ok]
        cand = cand[ok]
    return cand


def or_query(decoded: Dict[int, np.ndarray], terms: Sequence[int]) -> np.ndarray:
    terms = dedup_terms(terms)
    if not terms:
        return np.zeros(0, dtype=np.uint32)
    return np.unique(np.concatenate([decoded[t] for t in terms]))
