"""Sub-block statistics collection, numpy-vectorized.

The port of ``dint_tpu/stats/collectors.py``.  Reference semantics
(statistics_collectors.hpp):

* ``adjusted`` single collector (:109-118): for every list's gap
  stream and every target size s in {16,8,4,2,1}, count every aligned
  non-overlapping s-window (``len(list)//s`` windows per list).
* ``adjusted`` multi collector (:90-107): split each list into full
  256-int blocks (tail dropped), compute the block's selector
  ``ceil_log2(ceil_log2(max+1))`` (:21-40), and count each block's
  aligned windows of every target size into that selector's bucket.

The reference counts into ``unordered_map``s keyed by a 64-bit murmur
hash of the window bytes (collisions conflate windows).  We count by
exact content instead: windows are deduplicated with sort-based
weighted-unique over their raw bytes, which is collision-free and fully
vectorized.  A ``WindowCounter``'s large merges run on ``device``
through ``device_merge`` (torch ops; the card by default), under the
same size gates as the reference's; an error there raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..backend import resolve_device
from ..config import BLOCK_SIZE, NUM_SELECTORS, TARGET_SIZES
from . import device_merge

_POW2 = (np.uint64(1) << np.arange(64, dtype=np.uint64)).astype(np.uint64)


def ceil_log2(x: np.ndarray) -> np.ndarray:
    """Vectorized reference ceil_log2 (util.hpp:67-70): bit_length(x-1), 0 for x<=1."""
    x = np.asarray(x, dtype=np.uint64)
    # smallest k with 2^k >= x  ==  position of x in the sorted powers of 2
    return np.searchsorted(_POW2, x, side="left").astype(np.uint32)


def ceil_log2_int(x: int) -> int:
    return (int(x) - 1).bit_length() if x > 1 else 0


def selectors_for_blocks(blocks: np.ndarray) -> np.ndarray:
    """Selector code per 256-int block row (statistics_collectors.hpp:21-40)."""
    mx = blocks.max(axis=1).astype(np.int64)
    sel = np.zeros(mx.shape[0], dtype=np.int32)
    # sc = ceil_log2(ceil_log2(max+1)) for max > 1; thresholds:
    # 0: max<=1, 1: [2,3], 2: [4,15], 3: [16,255], 4: [256,65535], 5: >=65536
    sel += mx >= 2
    sel += mx >= 4
    sel += mx >= 16
    sel += mx >= 256
    sel += mx >= 65536
    return sel


def _rows_view(windows: np.ndarray) -> np.ndarray:
    """(W, s) u32 array -> (W,) opaque byte rows for sort/dedup."""
    w = np.ascontiguousarray(windows, dtype="<u4")
    return w.view(np.dtype((np.void, w.shape[1] * 4))).ravel()


def unique_weighted(rows: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted unique: returns (unique_rows, summed_weights)."""
    if rows.shape[0] == 0:
        return rows, weights
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    w = weights[order]
    boundary = np.empty(r.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = r[1:] != r[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(w, starts)
    return r[starts], sums


@dataclass
class WindowCounter:
    """Streaming exact counter of fixed-size windows, with periodic
    merges; a merge that passes ``device_merge``'s gates runs on
    ``device``, the others in numpy."""

    size: int
    merge_threshold: int = 4 << 20  # rows
    device: str = "cuda"
    _rows: List[np.ndarray] = field(default_factory=list)
    _weights: List[np.ndarray] = field(default_factory=list)
    _pending: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def add(self, windows: np.ndarray, weights: np.ndarray | None = None) -> None:
        if windows.shape[0] == 0:
            return
        rows = _rows_view(windows)
        if weights is None:
            weights = np.ones(rows.shape[0], dtype=np.int64)
        self._rows.append(rows)
        self._weights.append(np.asarray(weights, dtype=np.int64))
        self._pending += rows.shape[0]
        if self._pending > self.merge_threshold:
            self._merge()

    def _merge(self) -> None:
        rows = np.concatenate(self._rows)
        weights = np.concatenate(self._weights)
        got = device_merge.unique_weighted_device(
            rows.view("<u4").reshape(-1, self.size), weights,
            device=self.device,
        )
        if got is not None:
            r, w = _rows_view(got[0]), got[1]
        else:
            r, w = unique_weighted(rows, weights)
        self._rows = [r]
        self._weights = [w]
        self._pending = r.shape[0]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (windows (U, size) u32, freqs (U,) i64)."""
        if not self._rows:
            return np.zeros((0, self.size), dtype=np.uint32), np.zeros(0, np.int64)
        self._merge()
        rows, weights = self._rows[0], self._weights[0]
        windows = rows.view("<u4").reshape(-1, self.size)
        return windows, weights


def collect_single(gap_lists, device="cuda") -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """adjusted<16> single-map collection over whole lists.

    Returns {size: (windows, freqs)} for each target size.
    """
    counters = {s: WindowCounter(s, device=device) for s in TARGET_SIZES}
    for buf in gap_lists:
        buf = np.asarray(buf, dtype=np.uint32)
        n = buf.shape[0]
        for s in TARGET_SIZES:
            m = n // s
            if m:
                counters[s].add(buf[: m * s].reshape(m, s))
    return {s: counters[s].finalize() for s in TARGET_SIZES}


def collect_multi(gap_lists, device="cuda") -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]:
    """adjusted<16> per-selector collection over full 256-int blocks.

    Returns {(selector, size): (windows, freqs)}.
    """
    counters = {
        (sel, s): WindowCounter(s, device=device)
        for sel in range(NUM_SELECTORS)
        for s in TARGET_SIZES
    }
    block_chunks: List[np.ndarray] = []
    pending = 0

    def flush():
        nonlocal block_chunks, pending
        if not block_chunks:
            return
        blocks = np.concatenate(block_chunks, axis=0)
        block_chunks = []
        pending = 0
        sels = selectors_for_blocks(blocks)
        for sel in range(NUM_SELECTORS):
            mask = sels == sel
            if not mask.any():
                continue
            sel_blocks = blocks[mask]
            for s in TARGET_SIZES:
                counters[(sel, s)].add(sel_blocks.reshape(-1, s))

    for buf in gap_lists:
        buf = np.asarray(buf, dtype=np.uint32)
        nb = buf.shape[0] // BLOCK_SIZE
        if nb:
            block_chunks.append(buf[: nb * BLOCK_SIZE].reshape(nb, BLOCK_SIZE))
            pending += nb
            if pending * BLOCK_SIZE > (8 << 20):
                flush()
    flush()
    return {k: c.finalize() for k, c in counters.items()}
