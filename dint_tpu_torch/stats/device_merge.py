"""Device-backed weighted window dedup for statistics collection.

The port of ``dint_tpu/stats/device_merge.py``.  The exact-content
window counting of ``collectors.py`` spends its time in sort-based
weighted-unique merges, which numpy runs over void-dtype rows (memcmp
argsort).  Here the same merge runs as torch ops on ``device``: a
lexicographic sort over the window's u32 columns (content is the key,
so the merge is collision-free like the numpy one), boundary detection,
and segment sums from an int64 ``cumsum`` less a ``cummax`` of the
segment starts' exclusive sums.

The reference's ``jax.lax.sort(..., num_keys=s)`` has no torch
counterpart: the columns pack two to an int64 key (the first column in
the high word, signed, the second in the low word, unsigned) and the
rows take one stable sort a key, from the last key to the first.  The
order is a total order on the content, not the reference's, which the
statistics do not see (``block_stats._filter_sort`` sorts by count and
then by content).

Merges are chunked at ``CHUNK`` rows and chunk results tree-merge
through the same function, under the reference's gates: fewer than
``MIN_DEVICE_ROWS`` rows, weights past the int32 guards, or a round
that keeps more than 9/10 of its rows return ``None``, and the caller
merges in numpy.  The reference's backend and environment gate
(``DINT_TPU_DEVICE_STATS``) is the explicit ``device`` here; ``force``
skips the row-count gate only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..backend import resolve_device

MIN_DEVICE_ROWS = 1 << 20
CHUNK = 1 << 21
_MASK32 = 0xFFFFFFFF

_counts = {"merges": 0, "chunks": 0, "rows": 0}


def reset_merge_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def merge_counts() -> Dict[str, int]:
    """Merges that ran on a device (``unique_weighted_device`` calls that
    returned a result), the chunks they sorted and the rows those held."""
    return dict(_counts)


def _sort_keys(cols: torch.Tensor):
    """(s, N) int32 columns -> int64 keys, two columns a key: the
    first in the high word (signed), the second in the low word
    (unsigned); lexicographic order of the keys is a total order of the
    rows' content."""
    keys = []
    for i in range(0, cols.shape[0], 2):
        hi = cols[i].to(torch.int64)
        if i + 1 < cols.shape[0]:
            keys.append((hi << 32) | (cols[i + 1].to(torch.int64) & _MASK32))
        else:
            keys.append(hi)
    return keys


def _merge_fn(cols: torch.Tensor, weights: torch.Tensor):
    """cols (s, N) int32 window columns, weights (N,) int64 on one
    device -> (sorted cols, segment sums, start flags, end flags)."""
    N = cols.shape[1]
    order = torch.arange(N, device=cols.device)
    for key in reversed(_sort_keys(cols)):
        _, o = torch.sort(key[order], stable=True)
        order = order[o]
    scols = cols[:, order]
    w = weights[order]
    neq = (scols[:, 1:] != scols[:, :-1]).any(dim=0)
    one = torch.ones(1, dtype=torch.bool, device=cols.device)
    start = torch.cat([one, neq])
    end = torch.cat([neq, one])
    csum = torch.cumsum(w, 0)
    excl = csum - w
    # base[i] = csum just before i's segment start: excl at starts is
    # non-decreasing (w >= 0), so a running max propagates it
    base = torch.cummax(torch.where(start, excl, torch.zeros_like(excl)),
                        0).values
    return scols, csum - base, start, end


def _merge_chunk(s: int, windows: np.ndarray, weights: np.ndarray, device):
    """Merge one chunk (rows <= CHUNK) on ``device``; returns (unique
    windows (U, s) u32, counts (U,) int64)."""
    cols = torch.from_numpy(
        np.ascontiguousarray(windows.view(np.int32).T)).to(device)
    w = torch.from_numpy(np.asarray(weights, np.int64)).to(device)
    scols, sums, start, end = _merge_fn(cols, w)
    uniq = scols[:, start].T
    counts = sums[end]
    real = counts > 0  # the reference drops rows of weight 0 (its pads)
    uniq, counts = uniq[real].contiguous(), counts[real]
    _counts["chunks"] += 1
    _counts["rows"] += int(windows.shape[0])
    return (np.ascontiguousarray(uniq.cpu().numpy().view(np.uint32)),
            counts.cpu().numpy())


def unique_weighted_device(
    windows: np.ndarray, weights: np.ndarray, force: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray] | None:
    """(U, s) u32 windows + (U,) weights -> (unique windows, counts) on
    ``device``, or None where the reference's gates send the merge to
    numpy.  ``force`` skips the row-count gate (the tests run the merge
    on small inputs)."""
    N, s = windows.shape
    if not force and N < MIN_DEVICE_ROWS:
        return None
    if weights.max(initial=0) > np.iinfo(np.int32).max // 2:
        return None  # the reference keeps its i32 segment sums exact
    if weights.sum() > np.iinfo(np.int32).max // 2:
        return None  # the reference's global i32 cumsum must stay exact
    dev = resolve_device(device)
    if N == 0:
        return np.zeros((0, s), np.uint32), np.zeros(0, np.int64)
    windows = np.ascontiguousarray(windows, dtype="<u4")
    weights = np.asarray(weights)
    for _ in range(8):  # tree-merge rounds; dedup shrinks each round
        if windows.shape[0] <= CHUNK:
            got = _merge_chunk(s, windows, weights, dev)
            _counts["merges"] += 1
            return got
        parts = [
            _merge_chunk(s, windows[i : i + CHUNK], weights[i : i + CHUNK],
                         dev)
            for i in range(0, windows.shape[0], CHUNK)
        ]
        before = windows.shape[0]
        windows = np.concatenate([p[0] for p in parts])
        weights = np.concatenate([p[1] for p in parts])
        if windows.shape[0] > before * 9 // 10:
            return None  # barely deduping: numpy finish is cheaper
    return None
