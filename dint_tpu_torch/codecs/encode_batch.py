"""Batched DINT encoding through the native C++ encoder.

The port carries only the native branches of the reference package's
batch encoder: the single-dictionary optimal parse (chunked at
OPT_CHUNK ints per unit) and the multi-dictionary exhaustive-trial
parse (256-int blocks, one selector byte each).  Both write the same
bytes as the reference package for the same dictionary.  Without the
native library the encoder raises; the numpy and scalar oracles stay in
the reference package, where the tests read them.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from . import native

OPT_CHUNK = 8192


def _units(lists: Sequence[np.ndarray], chunk: int):
    units: List[np.ndarray] = []
    spans: List[Tuple[int, int]] = []
    for g in lists:
        s = len(units)
        for i in range(0, max(1, g.shape[0]), chunk):
            units.append(g[i : i + chunk])
        spans.append((s, len(units)))
    return units, spans


def _encode(d, lists, chunk: int, mode: int):
    if os.environ.get("DS2I_HEURISTIC_GREEDY", "") in ("1", "true", "True"):
        raise NotImplementedError(
            "DS2I_HEURISTIC_GREEDY: the greedy parse is not ported"
        )
    ne = native.native_encoder_for(d)
    if ne is None:
        raise RuntimeError(
            "native DINT encoder unavailable (g++ and "
            "native/dint_encoder.cpp are required)"
        )
    units, spans = _units(lists, chunk)
    encoded = ne.encode_units(units, mode=mode)
    streams = [b"".join(encoded[s:e]) for s, e in spans]
    unit_lens = [[len(u) for u in encoded[s:e]] for s, e in spans]
    return streams, unit_lens


def encode_single_lists(
    d, lists: Sequence[np.ndarray]
) -> Tuple[List[bytes], List[List[int]]]:
    """Single-dict optimal encode: (per-list streams, per-list chunk
    byte lengths)."""
    return _encode(d, lists, OPT_CHUNK, 0)


def encode_multi_lists(
    d, lists: Sequence[np.ndarray]
) -> Tuple[List[bytes], List[List[int]]]:
    """Multi-dict exhaustive-trial encode: (per-list streams, per-list
    block byte lengths incl. the selector byte)."""
    return _encode(d, lists, BLOCK_SIZE, 1)
