"""Host-side planning and the device engine of the RAW (chain-scan)
decode.

Buckets encoded units (list chunks or 256-int blocks) into a small set
of fixed shape classes, splits them into clean (no possible exception
marker anywhere in the token range — the chain scan is skipped) and
dirty groups, cuts them into tiles of at most ``B_TILE_*`` units, and
runs the structure-discovering decoder (``decode_xla.py``) over every
tile of a pass at once: on the card one X3 launch, on the CPU its plain
version in PyTorch ops tile by tile.
This engine discovers codeword boundaries on the device; the localized
engine (``decode_local.py``) is the fast path.  Load-time planning here
is the analogue of the reference's mmap + header walk
(vroom_env/decode.cpp:24-48).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..config import EXCEPTIONS
from ..dictionary.dictionary import DecodeView
from . import decode_xla


@dataclass
class Bucket:
    indices: np.ndarray  # unit ids in this bucket
    W: int  # token capacity (power of two)
    N: int  # output capacity (power of two)
    b: int  # codeword width in bits
    clean: bool
    cw: np.ndarray  # (B, W) int32 host tokens
    w_valid: np.ndarray
    n: np.ndarray
    ctx: np.ndarray


def _pow2(x: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(2, x)))))


def small_word_flags(arena: np.ndarray, b: int) -> Tuple[np.ndarray, ...]:
    """Prefix counts of possible exception markers for clean/dirty tests.

    b=16: two parity-phased u16 streams; b=8: one byte stream.  Returns
    cumulative counts so any unit's token range is testable in O(1).
    """
    if b == 8:
        small = arena < EXCEPTIONS
        return (np.concatenate([[0], np.cumsum(small)]),)
    a = arena.astype(np.uint16)
    even = a[0 : a.shape[0] - 1 : 2] | (a[1::2] << 8)
    odd = a[1 : a.shape[0] - 1 : 2] | (a[2::2] << 8)
    ce = np.concatenate([[0], np.cumsum(even < EXCEPTIONS)])
    co = np.concatenate([[0], np.cumsum(odd < EXCEPTIONS)])
    return ce, co


def units_are_clean(
    prefix_counts: Tuple[np.ndarray, ...],
    starts: np.ndarray,
    token_counts: np.ndarray,
    b: int,
) -> np.ndarray:
    starts = np.asarray(starts, dtype=np.int64)
    tc = np.asarray(token_counts, dtype=np.int64)
    if b == 8:
        (c,) = prefix_counts
        lo = np.clip(starts, 0, c.shape[0] - 1)
        hi = np.clip(starts + tc, 0, c.shape[0] - 1)
        return c[hi] == c[lo]
    ce, co = prefix_counts
    q0 = starts // 2
    even_phase = starts % 2 == 0
    out = np.zeros(starts.shape[0], dtype=bool)
    for phase, c in ((True, ce), (False, co)):
        m = even_phase == phase
        if not m.any():
            continue
        lo = np.clip(q0[m], 0, c.shape[0] - 1)
        hi = np.clip(q0[m] + tc[m], 0, c.shape[0] - 1)
        out[m] = c[hi] == c[lo]
    return out


# Output-capacity shape classes: clean units satisfy tokens <= n so
# W == N, dirty units get W = 4N (b=16 worst case is 3 tokens/int) or
# 8N (b=8, 5/int).
N_CLASSES = (256, 1024, 8192)


def plan_buckets(
    arena: np.ndarray,
    starts: np.ndarray,
    byte_lens: np.ndarray,
    n: np.ndarray,
    ctx: np.ndarray,
    b: int,
) -> List[Bucket]:
    """Bucket units into the fixed shape classes, split clean/dirty."""
    tw = b // 8
    token_counts = (np.asarray(byte_lens, dtype=np.int64) + tw - 1) // tw
    prefix = small_word_flags(arena, b)
    clean = units_are_clean(prefix, starts, token_counts, b)
    n = np.asarray(n)
    keys: Dict[Tuple[int, int, bool], List[int]] = {}
    for i in range(len(starts)):
        N = next((c for c in N_CLASSES if int(n[i]) <= c), None)
        if N is None:
            N = _pow2(int(n[i]))
        cl = bool(clean[i])
        if cl:
            W = N
        else:
            W = _pow2(N * (4 if b == 16 else 8))
            W = max(W, _pow2(int(token_counts[i])))
        keys.setdefault((W, N, cl), []).append(i)
    buckets = []
    for (W, N, cl), idxs in sorted(keys.items()):
        idxs = np.asarray(idxs, dtype=np.int64)
        cw = decode_xla.tokens_from_arena(arena, np.asarray(starts)[idxs], W, b)
        buckets.append(
            Bucket(
                idxs,
                W,
                N,
                b,
                cl,
                cw,
                token_counts[idxs].astype(np.int32),
                n[idxs].astype(np.int32),
                np.asarray(ctx)[idxs].astype(np.int32),
            )
        )
    return buckets


# Units a decode call at most: the chain scan of a dirty tile holds
# D*D boolean planes of B_TILE_DIRTY x W (plus as much again while it
# composes them), so the tile bounds the scan's device memory; clean
# tiles skip the scan and can be larger.
B_TILE_CLEAN = 2048
B_TILE_DIRTY = 256


class DecodeEngine:
    """Holds device-resident dictionary + bucket tiles on ``device``;
    runs the full decode.  Tiles are cut at ``B_TILE_*`` units and not
    padded: no shape has to repeat.  Every tile's tokens, w_valid, n and
    ctx are uploaded once into one ``decode_xla.PassTable`` (the tiles'
    tensors are views of it), checked once, and a pass is one
    ``decode_xla.decode_pass``: on the card one X3 launch."""

    def __init__(self, view: DecodeView, buckets: List[Bucket],
                 device="cuda"):
        self.device = resolve_device(device)
        self.view = view

        def up(a, dtype=np.int32):
            # int32 tensor of a's values (u32 arrays: of their bits)
            a = np.ascontiguousarray(a, dtype)
            return torch.from_numpy(a.view(np.int32)).to(self.device)

        self.lengths = up(view.lengths)
        self.offsets = up(view.offsets, np.uint32)
        self.table = up(view.table, np.uint32)
        self.buckets = buckets
        keys, tiles = [], []
        for bi, bk in enumerate(buckets):
            tile = B_TILE_CLEAN if bk.clean else B_TILE_DIRTY
            B = bk.cw.shape[0]
            for r0 in range(0, B, tile):
                rows = min(tile, B - r0)
                sl = slice(r0, r0 + rows)
                keys.append((bi, r0, rows))
                tiles.append((bk.cw[sl], bk.w_valid[sl], bk.n[sl],
                              bk.ctx[sl], bk.b, bk.N, bk.clean))
        self.pass_table = decode_xla.pass_table(tiles, self.lengths,
                                                self.offsets, self.table)
        # (bucket_idx, row0, rows, cw, wv, n, ctx), views of the pass table
        self.tiles = [(*k, *self.pass_table.tile(i))
                      for i, k in enumerate(keys)]

    def census(self) -> Dict[str, object]:
        """Units clean and dirty, and tiles per (W, N, b, clean)."""
        tiles: Dict[str, int] = {}
        for bi, *_ in self.tiles:
            bk = self.buckets[bi]
            key = f"{bk.W}/{bk.N}/{bk.b}/{'clean' if bk.clean else 'dirty'}"
            tiles[key] = tiles.get(key, 0) + 1
        return {
            "units_clean": int(sum(bk.indices.shape[0]
                                   for bk in self.buckets if bk.clean)),
            "units_dirty": int(sum(bk.indices.shape[0]
                                   for bk in self.buckets if not bk.clean)),
            "tiles": tiles,
        }

    def decode_all(self):
        """One decode pass over every tile; returns device outputs
        [(out (rows, N) int32 u32 bits, produced, consumed)] a tile."""
        return decode_xla.decode_pass(self.pass_table)

    def block_and_check(self, outs) -> int:
        total = 0
        for (out, produced, _c), (bi, r0, rows, *_rest) in zip(outs, self.tiles):
            bk = self.buckets[bi]
            produced = produced.cpu().numpy()[:rows]
            expect = bk.n[r0 : r0 + rows]
            if not (produced == expect).all():
                bad = np.flatnonzero(produced != expect)[:5]
                raise ValueError(
                    f"decode produced wrong counts for units "
                    f"{bk.indices[r0 + bad]}"
                )
            total += int(produced.sum())
        return total

    def iter_unit_outputs(self, outs):
        """Yields (unit_id, host_row (N,) u32, n) for every unit."""
        for (out, _p, _c), (bi, r0, rows, *_rest) in zip(outs, self.tiles):
            bk = self.buckets[bi]
            host = out.cpu().numpy().view(np.uint32)
            for j in range(rows):
                uid = int(bk.indices[r0 + j])
                yield uid, host[j], int(bk.n[r0 + j])
