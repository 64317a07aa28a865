"""Vectorized content hashing for window/entry matching.

The reference keys its encode-side maps by 64-bit murmur of the window
bytes (hash_utils.hpp:7-71) and silently tolerates collisions.  We use
a slideable 64-bit polynomial hash over per-element mixed values plus
exact content verification of every candidate, so collisions cost a
probe, never a wrong encoding.

Canonical hash of a window (x_0..x_{L-1}):
    h = sum_t mix64(x_t) * PINV^t  (mod 2^64)
The PINV-power weighting makes the hash of every sliding window
computable from one prefix-sum pass (`rolling_window_hashes`), which is
what lets the batched encoder hash all positions x all target sizes
without materializing windows.
"""

from __future__ import annotations

import numpy as np

# odd constant and its modular inverse mod 2^64
_P = np.uint64(0x9E3779B97F4A7C15)
_PINV = np.uint64(pow(0x9E3779B97F4A7C15, -1, 1 << 64))


def mix64(x: np.ndarray) -> np.ndarray:
    """Elementwise 64-bit finalizer (splitmix-style) of u32 values."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def hash_u64(windows: np.ndarray) -> np.ndarray:
    """(B, L) u32 -> (B,) u64 canonical window hash."""
    windows = np.ascontiguousarray(windows, dtype=np.uint32)
    with np.errstate(over="ignore"):
        y = mix64(windows)
        h = np.zeros(windows.shape[0], dtype=np.uint64)
        p = np.uint64(1)
        for t in range(windows.shape[1]):
            h += y[:, t] * p
            p *= _PINV
    return h


def rolling_window_hashes(gaps: np.ndarray, L: int) -> np.ndarray:
    """(B, W) u32 -> (B, W-L+1) u64: hash_u64 of every length-L window.

    h(window at i) = (T[i+L] - T[i]) * P^i where T is the exclusive
    prefix sum of mix64(x_j) * PINV^j — identical to hash_u64 on the
    materialized window.
    """
    B, W = gaps.shape
    assert W >= L
    with np.errstate(over="ignore"):
        y = mix64(np.ascontiguousarray(gaps, dtype=np.uint32))
        pinv_pows = _pows(_PINV, W)
        p_pows = _pows(_P, W - L + 1)
        c = y * pinv_pows[None, :]
        T = np.zeros((B, W + 1), dtype=np.uint64)
        np.cumsum(c, axis=1, out=T[:, 1:])
        return (T[:, L : W + 1] - T[:, : W - L + 1]) * p_pows[None, :]


_POW_CACHE: dict = {}


def _pows(base: np.uint64, count: int) -> np.ndarray:
    """[1, base, base^2, ...] mod 2^64, cached per (base, >=count)."""
    key = int(base)
    cached = _POW_CACHE.get(key)
    if cached is None or cached.shape[0] < count:
        size = max(count, 1 << 14)
        with np.errstate(over="ignore"):
            arr = np.full(size, base, dtype=np.uint64)
            arr[0] = 1
            arr = np.cumprod(arr)
        _POW_CACHE[key] = arr
        cached = arr
    return cached[:count]
