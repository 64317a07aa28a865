"""Gap transforms.

Reference semantics (block_statistics.hpp:69-76, vroom_env/encode.cpp:96-110):
docID lists become d-gaps ``doc[i] - doc[i-1] - 1`` with an implicit
previous value of -1 (so the first gap is ``doc[0]``); frequency lists
become ``freq - 1``.  Both are exactly invertible.
"""

from __future__ import annotations

import numpy as np


def docs_to_gaps(docs: np.ndarray) -> np.ndarray:
    docs = np.asarray(docs, dtype=np.int64)
    if docs.shape[0] == 0:  # empty posting list (shard-absent term)
        return np.zeros(0, np.uint32)
    out = np.empty_like(docs)
    out[0] = docs[0]
    out[1:] = docs[1:] - docs[:-1] - 1
    return out.astype(np.uint32)


def gaps_to_docs(gaps: np.ndarray) -> np.ndarray:
    g = np.asarray(gaps, dtype=np.int64)
    return (np.cumsum(g + 1) - 1).astype(np.uint32)


def freqs_to_gaps(freqs: np.ndarray) -> np.ndarray:
    return (np.asarray(freqs, dtype=np.int64) - 1).astype(np.uint32)


def gaps_to_freqs(gaps: np.ndarray) -> np.ndarray:
    return (np.asarray(gaps, dtype=np.int64) + 1).astype(np.uint32)
