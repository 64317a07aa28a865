"""Batched DINT encoding: the native C++ encoder and the numpy coders.

Two routes write the same bytes for the same dictionary:

* the native encoder (``codecs/native.py`` over
  ``native/dint_encoder.cpp``), the default (``prefer_native=True``);
  where its library does not build it raises with the build error;
* the numpy coders below (``prefer_native=False``), the oracle the
  native encoder is held to.  They re-express the reference's per-list
  shortest-path parse (vroom_env/dint_codecs.hpp:190-330, :332-518) as
  array programs over a whole batch of units at once:

  - window->codeword lookups for every position and target size are
    precomputed with dedup + hashed matching (LookupTable.lookup_batch);
  - the DP runs as a Python loop over positions (bounded by the bucket
    length) doing O(1) vector relaxations over the batch axis, so the
    "prepare parallel / commit in order" contract of the reference's
    semiasync_queue becomes deterministic batch ordering;
  - path extraction uses pointer doubling over the parent arrays, and
    byte emission assembles token streams with cumsum offsets.

Exact-parity notes: the DP cost model (1 codeword per dict hit/run,
2/3 for small/large exceptions, initial nodes = chains of cost-3
exceptions) and the strict '>' relaxation mirror the reference, so the
minimum cost, and therefore the encoded size, matches the reference
parse for the same dictionary.  Single-dictionary lists are parsed in
independent chunks of OPT_CHUNK ints (the reference parses whole
lists); a parse boundary costs at most one extra codeword per chunk,
bounded by 16/OPT_CHUNK bpi.  Multi-dictionary lists are parsed in
256-int blocks, each with its selector byte.

``DS2I_HEURISTIC_GREEDY=1`` (the C++ reference's switch,
configuration.hpp:29-34) selects the greedy parse of
``codecs/dint.encode_greedy_single`` for single-dictionary lists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import (
    BLOCK_SIZE,
    EXCEPTIONS,
    NUM_SELECTORS,
    SMALL_EXCEPTION_LIMIT,
    TARGET_SIZES,
)
from ..dictionary.dictionary import LookupTable, MultiPackedDictionary
from ..utils import nativebuild
from . import native

OPT_CHUNK = 8192
_RUN_KS = (256, 128, 64, 32, 16)


def _units(lists: Sequence[np.ndarray], chunk: int):
    """Each list cut into units of at most ``chunk`` ints (an empty list
    is one empty unit); returns (units, per-list (first, end) spans)."""
    units: List[np.ndarray] = []
    spans: List[Tuple[int, int]] = []
    for g in lists:
        s = len(units)
        for i in range(0, max(1, g.shape[0]), chunk):
            units.append(g[i : i + chunk])
        spans.append((s, len(units)))
    return units, spans


def _join(encoded: Sequence[bytes], spans):
    """(per-list streams, per-list unit byte lengths)."""
    streams = [b"".join(encoded[s:e]) for s, e in spans]
    unit_lens = [[len(u) for u in encoded[s:e]] for s, e in spans]
    return streams, unit_lens


def _native_encoder(d) -> "native.NativeEncoder":
    ne = native.native_encoder_for(d)
    if ne is None:
        raise RuntimeError(
            "native DINT encoder unavailable (g++ and "
            "native/dint_encoder.cpp are required): "
            + nativebuild.errors.get("libdintenc.so", "build failed").strip()
            + "; pass prefer_native=False for the numpy coders"
        )
    return ne


def pad_units(units: Sequence[np.ndarray], L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad unit gap arrays to (B, L); padding is 1 (terminates zero runs)."""
    B = len(units)
    out = np.ones((B, L), dtype=np.uint32)
    n = np.zeros(B, dtype=np.int32)
    for i, u in enumerate(units):
        n[i] = u.shape[0]
        out[i, : u.shape[0]] = u
    return out, n


def zero_run_lengths(gaps: np.ndarray, n: np.ndarray) -> np.ndarray:
    """z[b, i] = length of zero run starting at i (within unit), capped 256."""
    B, L = gaps.shape
    pos = np.arange(L, dtype=np.int64)[None, :]
    valid = pos < n[:, None]
    nz = (gaps != 0) | ~valid
    nz_pos = np.where(nz, pos, L)
    # next nonzero at or after i: suffix minimum
    next_nz = np.minimum.accumulate(nz_pos[:, ::-1], axis=1)[:, ::-1]
    z = next_nz - pos
    return np.minimum(z, 256).astype(np.int32)


def precompute_hits(
    lookup: LookupTable, gaps: np.ndarray, n: np.ndarray
) -> Dict[int, np.ndarray]:
    """{size: (B, L) int64 codeword index or -1} for full in-unit windows."""
    B, L = gaps.shape
    hits: Dict[int, np.ndarray] = {}
    pos = np.arange(L, dtype=np.int64)[None, :]
    for s in TARGET_SIZES:
        h = np.full((B, L), -1, dtype=np.int64)
        if L >= s:
            h[:, : L - s + 1] = lookup.lookup_rolling(gaps, s)
        h[pos + s > n[:, None]] = -1
        hits[s] = h
    return hits


def hits8_from_hits16(hits16: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """b=8 maps contain only indices < 256 (multi_dictionary.hpp:210-212)."""
    return {s: np.where(h < 256, h, -1) for s, h in hits16.items()}


def opt_parse_batch(
    hits: Dict[int, np.ndarray], gaps: np.ndarray, n: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched shortest-path DP. Returns (parent, codeword, cost) (B, L+1).

    Destination-driven reformulation of the reference's source-driven
    relaxation (single_opt_dint :196-258): cost[j] = min over incoming
    edges, with candidates stacked in the reference's write order so
    np.argmin's first-minimum tie-break reproduces its strict-'>'
    first-writer-wins exactly.  Candidate order for destination j (by
    ascending source, then the reference's within-iteration order):
    run-256 .. run-16, dict-16 .. dict-1, exception.  The reference's
    initial nodes (parent j-1, codeword 1, cost 3j) are subsumed by the
    exception candidate, which has the same parent/codeword when large
    and never costs more.
    """
    B, L = gaps.shape
    z = zero_run_lengths(gaps, n)
    BIG = np.int64(1) << 60
    cost = np.full((B, L + 1), BIG, dtype=np.int64)
    cost[:, 0] = 0
    parent = np.zeros((B, L + 1), dtype=np.int32)
    codeword = np.ones((B, L + 1), dtype=np.int32)
    is_large = gaps >= SMALL_EXCEPTION_LIMIT

    # candidate metadata: (span, kind, payload)
    # kind 0 = run (payload = codeword), 1 = dict hit, 2 = exception
    cand_spans = [k for k in _RUN_KS] + [s for s in TARGET_SIZES] + [1]
    ncand = len(cand_spans)
    cc = np.empty((ncand, B), dtype=np.int64)
    cwc = np.empty((ncand, B), dtype=np.int32)
    nmax = int(n.max()) if B else 0
    for j in range(1, nmax + 1):
        ci = 0
        for t, k in enumerate(_RUN_KS):
            if j >= k:
                src = j - k
                act = z[:, src] >= k
                cc[ci] = np.where(act, cost[:, src] + 1, BIG)
                cwc[ci] = EXCEPTIONS + t
            else:
                cc[ci] = BIG
            ci += 1
        for s in TARGET_SIZES:
            if j >= s:
                src = j - s
                h = hits[s][:, src]
                cc[ci] = np.where(h >= 0, cost[:, src] + 1, BIG)
                cwc[ci] = h.astype(np.int32)
            else:
                cc[ci] = BIG
            ci += 1
        src = j - 1
        lrg = is_large[:, src]
        cc[ci] = cost[:, src] + 2 + lrg
        cwc[ci] = lrg.astype(np.int32)
        sel = np.argmin(cc, axis=0)
        rows = np.arange(B)
        cost[:, j] = cc[sel, rows]
        spans = np.asarray(cand_spans, dtype=np.int32)[sel]
        parent[:, j] = j - spans
        codeword[:, j] = cwc[sel, rows]
    # out-of-range destinations (j > n) keep harmless defaults
    return parent, codeword, cost


def extract_paths(parent: np.ndarray, n: np.ndarray) -> np.ndarray:
    """(B, L+1) visited-node mask of each unit's optimal path (pointer doubling)."""
    B, L1 = parent.shape
    P = parent.astype(np.int64).copy()
    mask = np.zeros((B, L1), dtype=bool)
    mask[np.arange(B), n] = True
    steps = max(1, int(np.ceil(np.log2(L1))))
    for _ in range(steps):
        r, c = np.nonzero(mask)
        mask[r, P[r, c]] = True
        P = np.take_along_axis(P, P, axis=1)
    return mask


def path_token_counts(visited: np.ndarray, codeword: np.ndarray, b: int) -> np.ndarray:
    """(B,) total stream bytes for each unit's path."""
    cw = codeword
    v = visited.copy()
    v[:, 0] = False
    if b == 16:
        per = np.where(cw > 1, 2, np.where(cw == 0, 4, 6))
    else:
        per = np.where(cw > 1, 1, np.where(cw == 0, 3, 5))
    return (per * v).sum(axis=1).astype(np.int64)


def emit_unit(
    visited_row: np.ndarray,
    codeword_row: np.ndarray,
    gaps_row: np.ndarray,
    b: int,
) -> bytes:
    """Assemble one unit's byte stream from its parse."""
    nodes = np.flatnonzero(visited_row)
    nodes = nodes[nodes > 0]  # ascending == path order; drop source
    cw = codeword_row[nodes]
    starts = np.concatenate([[0], nodes[:-1]])
    vals = gaps_row[starts].astype(np.uint32)
    if b == 16:
        ntok = np.where(cw > 1, 1, np.where(cw == 0, 2, 3))
        off = np.concatenate([[0], np.cumsum(ntok)])
        flat = np.zeros(off[-1], dtype=np.uint16)
        flat[off[:-1]] = cw.astype(np.uint16)
        small = cw == 0
        large = cw == 1
        flat[off[:-1][small] + 1] = (vals[small] & 0xFFFF).astype(np.uint16)
        flat[off[:-1][large] + 1] = (vals[large] & 0xFFFF).astype(np.uint16)
        flat[off[:-1][large] + 2] = (vals[large] >> 16).astype(np.uint16)
        return flat.astype("<u2").tobytes()
    ntok = np.where(cw > 1, 1, np.where(cw == 0, 3, 5))
    off = np.concatenate([[0], np.cumsum(ntok)])
    flat = np.zeros(off[-1], dtype=np.uint8)
    flat[off[:-1]] = cw.astype(np.uint8)
    small = cw == 0
    large = cw == 1
    s0 = off[:-1][small]
    flat[s0 + 1] = (vals[small] & 0xFF).astype(np.uint8)
    flat[s0 + 2] = ((vals[small] >> 8) & 0xFF).astype(np.uint8)
    l0 = off[:-1][large]
    for k in range(4):
        flat[l0 + 1 + k] = ((vals[large] >> (8 * k)) & 0xFF).astype(np.uint8)
    return flat.tobytes()


def encode_opt_units(
    lookup: LookupTable, units: Sequence[np.ndarray], b: int = 16
) -> List[bytes]:
    """Optimal-parse each unit independently, batched by size bucket."""
    out: List[bytes] = [b""] * len(units)
    buckets: Dict[int, List[int]] = {}
    for i, u in enumerate(units):
        L = 1 << max(0, int(np.ceil(np.log2(max(1, len(u))))))
        buckets.setdefault(L, []).append(i)
    for L, idxs in sorted(buckets.items()):
        CH = max(1, (64 << 20) // max(1, L * 8))  # bound memory per chunk
        for c0 in range(0, len(idxs), CH):
            chunk = idxs[c0 : c0 + CH]
            gaps, n = pad_units([units[i] for i in chunk], L)
            hits = precompute_hits(lookup, gaps, n)
            parent, codeword, _ = opt_parse_batch(hits, gaps, n)
            visited = extract_paths(parent, n)
            for j, i in enumerate(chunk):
                out[i] = emit_unit(visited[j], codeword[j], gaps[j], b)
    return out


def encode_opt_list(lookup: LookupTable, gaps_arr: np.ndarray, b: int = 16) -> bytes:
    """Whole-list optimal encode, chunked at OPT_CHUNK (see module docstring)."""
    n = gaps_arr.shape[0]
    if n <= OPT_CHUNK:
        return encode_opt_units(lookup, [gaps_arr], b)[0]
    chunks = [gaps_arr[i : i + OPT_CHUNK] for i in range(0, n, OPT_CHUNK)]
    return b"".join(encode_opt_units(lookup, chunks, b))


def encode_opt_lists(
    lookup: LookupTable, lists: Sequence[np.ndarray], b: int = 16
) -> Tuple[List[bytes], List[List[int]]]:
    """Returns (per-list streams, per-list chunk byte lengths)."""
    units, spans = _units(lists, OPT_CHUNK)
    return _join(encode_opt_units(lookup, units, b), spans)


def encode_single_lists(
    d, lists: Sequence[np.ndarray], prefer_native: bool = True
) -> Tuple[List[bytes], List[List[int]]]:
    """Single-dict optimal encode: (per-list streams, per-list chunk
    byte lengths).  ``prefer_native`` picks the native encoder (raises
    when it does not build), else the numpy coders;
    DS2I_HEURISTIC_GREEDY=1 selects the greedy parse instead of the
    shortest-path DP."""
    units, spans = _units(lists, OPT_CHUNK)
    if os.environ.get("DS2I_HEURISTIC_GREEDY", "") in ("1", "true", "True"):
        from . import dint as dint_mod

        lt = d.lookup_table()
        encoded = [dint_mod.encode_greedy_single(lt, u) for u in units]
    elif prefer_native:
        encoded = _native_encoder(d).encode_units(units, mode=0)
    else:
        encoded = encode_opt_units(d.lookup_table(), units, 16)
    return _join(encoded, spans)


def encode_multi_lists(
    d: MultiPackedDictionary, lists: Sequence[np.ndarray],
    prefer_native: bool = True,
) -> Tuple[List[bytes], List[List[int]]]:
    """Multi-dict exhaustive-trial encode: (per-list streams, per-list
    block byte lengths incl. the selector byte).  ``prefer_native``
    picks the native encoder (raises when it does not build), else
    ``encode_multi_opt_lists``."""
    if not prefer_native:
        return encode_multi_opt_lists(d, lists)
    units, spans = _units(lists, BLOCK_SIZE)
    return _join(_native_encoder(d).encode_units(units, mode=1), spans)


def encode_multi_opt_lists(
    dict_: MultiPackedDictionary, lists: Sequence[np.ndarray]
) -> Tuple[List[bytes], List[List[int]]]:
    """Multi-dictionary exhaustive-trial encode of many lists.

    Each 256-int chunk is parsed under all NUM_SELECTORS contexts for
    b=16 and b=8; the smallest real byte size wins with the reference's
    tie-breaks (multi_opt_dint :467-489).  Returns (per-list streams,
    per-list block byte lengths incl. the selector byte).
    """
    units, spans = _units(lists, BLOCK_SIZE)
    lt16s, lt8s = dict_.lookup_tables()

    unit_bytes: List[bytes] = [b""] * len(units)
    CH = 4096
    for c0 in range(0, len(units), CH):
        chunk = units[c0 : c0 + CH]
        gaps, n = pad_units(chunk, BLOCK_SIZE)
        B = gaps.shape[0]
        best_size = np.full(B, 1 << 60, dtype=np.int64)
        best_sc = np.zeros(B, dtype=np.int32)
        parses = []  # (visited, codeword) per trial sc
        for s in range(NUM_SELECTORS):
            hits16 = precompute_hits(lt16s[s], gaps, n)
            hits8 = hits8_from_hits16(hits16)
            p16, cw16, _ = opt_parse_batch(hits16, gaps, n)
            v16 = extract_paths(p16, n)
            sz16 = path_token_counts(v16, cw16, 16)
            p8, cw8, _ = opt_parse_batch(hits8, gaps, n)
            v8 = extract_paths(p8, n)
            sz8 = path_token_counts(v8, cw8, 8)
            parses.append((v16, cw16))
            parses.append((v8, cw8))
            # within-selector: b=8 wins ties; across: strictly smaller
            sel8 = sz8 <= sz16
            sz = np.where(sel8, sz8, sz16)
            sc = np.where(sel8, s + NUM_SELECTORS, s)
            better = sz < best_size
            best_size[better] = sz[better]
            best_sc[better] = sc[better]
        for j in range(B):
            sc = int(best_sc[j])
            trial = (sc % NUM_SELECTORS) * 2 + (1 if sc >= NUM_SELECTORS else 0)
            v, cw = parses[trial]
            body = emit_unit(v[j], cw[j], gaps[j], 8 if sc >= NUM_SELECTORS else 16)
            unit_bytes[c0 + j] = bytes([sc]) + body
    return _join(unit_bytes, spans)
