"""Batched DINT decode of the raw chain-scan engine: X3, a hand kernel
a tile on the card (``csrc/raw_decode.cu``), and its plain version in
PyTorch ops.

The reference decode (vroom_env/dint_codecs.hpp:37-107) is a sequential
pointer walk: read a codeword, copy a dictionary entry or consume an
inline exception, advance a data-dependent number of stream words.
Here it runs as three dense phases over a whole batch of encoded units
(lists or 256-int blocks) at once, as in the reference package's
``kernels/decode_xla.py``:

1. **Classify**: view each unit's byte range as a token stream
   (u16 for b=16, u8 for b=8) and compute, for every token position,
   its step (1 token for a dictionary codeword, 1+2/tw for a 2-byte
   exception, 1+4/tw for a 4-byte one) and output length.

2. **Chain**: the walk visits positions 0, f(0), f(f(0)), ... where
   f(q) = q + step(q).  Steps are bounded (<= 3 token widths for b=16,
   <= 5 for b=8), so visited-ness is a short linear recurrence over the
   boolean semiring, solved for all positions at once by a log-step
   (Hillis-Steele) inclusive scan over per-position D x D transition
   matrices.  Units whose token range holds no word < EXCEPTIONS cannot
   hold an exception marker: every position is a codeword start and the
   scan is skipped (the host planner buckets units into clean/dirty).

3. **Gather**: exclusive prefix sums of visited output lengths give each
   codeword's output offset; every output slot gathers its value from
   the dictionary table (or the inline exception words).  Run codewords
   (length > 16) read zeros beyond the 16-word zero region, matching the
   reference's pre-zeroed buffer + 16-word memcpy trick
   (dict_posting_list.hpp:296, single_dictionary.hpp:230-238).

``decode_units`` is the dispatcher: on CUDA tensors it launches X3 (one
warp a row, the chain solved 32 tokens at a time by a warp scan of the
same boolean matrices, see the source's note) or raises; on CPU tensors
it runs ``decode_units_plain``, the three phases above as torch ops.

u32 data travels as int32 bit patterns: the table and the decoded
values are int32 tensors holding u32 bits, and the exception values are
assembled in int64 and wrapped back.  Index rules follow the
reference's gathers exactly: a negative ordinal wraps to the last one,
dictionary and table indices are clamped, and scatters that the
reference drops go to one padded column that is sliced off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import EXCEPTIONS, MAX_ENTRY_SIZE
from .decode_local import _to_i32

_MASK = 0xFFFFFFFF


def _steps_for(b: int) -> Tuple[int, int, int]:
    """(dict, small_exc, large_exc) steps in token units."""
    tw = b // 8
    return 1, 1 + 2 // tw, 1 + 4 // tw


def _compose(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R = Y . X over the boolean semiring, elementwise over the trailing
    plane axes: R[i, j] = OR_k Y[i, k] & X[k, j].  x is the earlier
    prefix, y the later transform applied after it.  (D, D, ...) bool."""
    D = x.shape[0]
    r = y[:, 0, None] & x[None, 0]
    for k in range(1, D):
        r |= y[:, k, None] & x[None, k]
    return r


def _chain_visited(cw: torch.Tensor, b: int) -> torch.Tensor:
    """Visited mask over token positions via a log-step matrix scan.

    cw: (B, W) int32 token values.  Returns (B, W) bool.

    State s_q = (v_q, v_{q-1}, ..., v_{q-D+1}) with D the largest step;
    s_q = T_q s_{q-1}, where row 0 of T_q holds the recurrence taps
    v_q = v_{q-1} & dict_{q-1} | v_{q-s} & small_{q-s} | v_{q-l} &
    large_{q-l} and rows 1..D-1 shift the window.  The matrices are D*D
    (B, W-1) bool planes; the inclusive prefix P_q = T_q ... T_1 is
    built in ceil(log2(W-1)) doubling steps, and v_q = P_q[0, 0]
    (position 0 is always visited)."""
    B, W = cw.shape
    _, s_small, s_large = _steps_for(b)
    D = s_large  # max step == state depth
    if W == 1:
        return torch.ones((B, 1), dtype=torch.bool, device=cw.device)

    def shifted(x, k):
        # x_{q-k} aligned at q, False for q < k
        out = torch.zeros_like(x)
        if k < W:
            out[:, k:] = x[:, : W - k]
        return out

    a = shifted(cw >= EXCEPTIONS, 1)[:, 1:]
    bb = shifted(cw == 0, s_small)[:, 1:]
    cc = shifted(cw == 1, s_large)[:, 1:]
    L = W - 1
    T = torch.zeros((D, D, B, L), dtype=torch.bool, device=cw.device)
    T[0, 0] = a
    T[0, s_small - 1] |= bb
    T[0, s_large - 1] |= cc
    for i in range(1, D):
        T[i, i - 1] = True
    d = 1
    while d < L:
        later = T[..., d:]
        earlier = T[..., : L - d]
        T = torch.cat([T[..., :d], _compose(later, earlier)], dim=-1)
        d *= 2
    v0 = torch.ones((B, 1), dtype=torch.bool, device=cw.device)
    return torch.cat([v0, T[0, 0]], dim=1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 with the reference's rule for the one
    out-of-range index it meets: a negative index wraps."""
    idx = torch.where(idx < 0, idx + x.shape[1], idx)
    return torch.gather(x, 1, idx.to(torch.int64))


def decode_units_plain(
    cw: torch.Tensor,  # (B, W) int32 token values
    w_valid: torch.Tensor,  # (B,) int32 valid token count per unit
    n: torch.Tensor,  # (B,) int32 ints to produce per unit
    ctx: torch.Tensor,  # (B,) int32 dictionary context per unit
    lengths: torch.Tensor,  # (C, E) int32 entry lengths
    offsets: torch.Tensor,  # (C, E) int32 entry table offsets
    table: torch.Tensor,  # (T,) int32 flat table, u32 bits, zero padded
    *,
    b: int = 16,
    n_out: int = 256,
    assume_clean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X3's plain version: decode a bucket of units in torch ops on the
    tensors' device; returns ((B, n_out) int32 holding the u32 values,
    (B,) int32 produced, (B,) int32 tokens consumed to produce exactly n
    ints)."""
    dev = cw.device
    B, W = cw.shape
    _, s_small, s_large = _steps_for(b)
    E = lengths.shape[1]
    Tn = table.shape[0]

    qpos = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    in_range = qpos < w_valid[:, None]
    # out-of-range tokens look like dictionary codewords of length 0
    cw_safe = torch.where(in_range, cw, EXCEPTIONS)

    if assume_clean:
        visited = in_range
    else:
        visited = _chain_visited(cw_safe, b) & in_range

    ctx_l = ctx.to(torch.int64)[:, None]
    is_dict = cw_safe >= EXCEPTIONS
    ent_len = lengths[ctx_l, cw_safe.to(torch.int64).clamp(max=E - 1)]
    out_len = torch.where(is_dict, ent_len, 1)
    # unvisited and out-of-range positions produce nothing, so the ends
    # stay flat past the stream
    out_len = torch.where(visited, out_len, 0)

    ends = torch.cumsum(out_len, dim=1, dtype=torch.int32)  # inclusive
    produced = ends[:, -1]
    starts = ends - out_len

    # ordinal compaction of visited codewords; the reference's dropped
    # scatter slots land in column M, sliced off
    ordinal = torch.cumsum(visited, dim=1, dtype=torch.int32) - 1
    M = W  # max codewords
    scatter_idx = torch.where(visited, ordinal, M).to(torch.int64)
    pos_of_ord = torch.zeros((B, M + 1), dtype=torch.int32, device=dev)
    pos_of_ord.scatter_(1, scatter_idx, qpos.expand(B, W))
    pos_of_ord = pos_of_ord[:, :M]
    start_of_ord = torch.zeros((B, M + 1), dtype=torch.int32, device=dev)
    start_of_ord.scatter_(1, scatter_idx, starts)
    start_of_ord = start_of_ord[:, :M]

    # output slot -> ordinal: one mark at each codeword's start, cumsum.
    # Visited zero-length entries share a start, so the marks accumulate.
    num_ords = ordinal[:, -1] + 1
    ord_ids = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    ord_valid = ord_ids < num_ords[:, None]
    mark_idx = torch.where(ord_valid, start_of_ord, n_out)
    mark_idx = torch.where((mark_idx >= 0) & (mark_idx < n_out),
                           mark_idx, n_out).to(torch.int64)
    marks = torch.zeros((B, n_out + 1), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, mark_idx, torch.ones_like(mark_idx,
                                                    dtype=torch.int32))
    o_j = torch.cumsum(marks[:, :n_out], dim=1, dtype=torch.int32) - 1

    q_j = _take(pos_of_ord, o_j)
    st_j = _take(start_of_ord, o_j)
    jpos = torch.arange(n_out, dtype=torch.int32, device=dev)[None, :]
    k_j = jpos - st_j

    cw_j = _take(cw_safe, q_j)
    is_dict_j = cw_j >= EXCEPTIONS

    off_j = offsets[ctx_l, cw_j.to(torch.int64).clamp(max=E - 1)]
    k_clamped = torch.clamp(k_j, max=MAX_ENTRY_SIZE - 1)
    t_idx = (off_j + k_clamped).to(torch.int64)
    t_idx = torch.where(t_idx < 0, t_idx + Tn, t_idx).clamp(0, Tn - 1)
    tbl_val = table[t_idx].to(torch.int64) & _MASK
    dict_val = torch.where(k_j < MAX_ENTRY_SIZE, tbl_val, 0)

    # exception values from the following tokens (u32, built in int64)
    def tok(shift):
        idx = torch.clamp(q_j + shift, max=W - 1)
        return _take(cw_safe, idx).to(torch.int64) & _MASK

    if b == 16:
        small_val = tok(1)
        large_val = tok(1) | (tok(2) << 16)
    else:
        small_val = tok(1) | (tok(2) << 8)
        large_val = tok(1) | (tok(2) << 8) | (tok(3) << 16) | (tok(4) << 24)

    exc_val = torch.where(cw_j == 1, large_val, small_val) & _MASK
    val = torch.where(is_dict_j, dict_val, exc_val)
    val = torch.where(jpos < n[:, None], val, 0)

    # tokens consumed to produce exactly n ints: the codeword covering
    # output n-1, plus its payload — lets a second pass decode the data
    # that follows (e.g. the freqs half of an index block).
    last_j = torch.clamp(n - 1, 0, n_out - 1)[:, None]
    q_last = _take(q_j, last_j)[:, 0]
    cw_last = _take(cw_j, last_j)[:, 0]
    step_last = torch.where(
        cw_last >= EXCEPTIONS, 1,
        torch.where(cw_last == 1, s_large, s_small))
    consumed = (q_last + step_last).to(torch.int32)
    return _to_i32(val), produced, consumed


_X3_LIB = "libdintraw.so"


def _x3_check(cw, w_valid, n, ctx, lengths, offsets, table, b: int,
              n_out: int) -> None:
    """Raise unless every input is a contiguous int32 tensor on cw's
    device of the shapes ``decode_units`` takes, b is 8 or 16 and n_out
    is at least 1."""
    name = "decode_units"
    if b not in (8, 16):
        raise ValueError(f"{name}: b must be 8 or 16, got {b}")
    if n_out < 1:
        raise ValueError(f"{name}: n_out must be at least 1, got {n_out}")
    if cw.dim() != 2 or cw.shape[1] < 1:
        raise ValueError(f"{name}: cw must be (B, W) with W >= 1, got "
                         f"{tuple(cw.shape)}")
    B = cw.shape[0]
    for what, x in (("w_valid", w_valid), ("n", n), ("ctx", ctx)):
        if tuple(x.shape) != (B,):
            raise ValueError(f"{name}: {what} must be ({B},), got "
                             f"{tuple(x.shape)}")
    if (lengths.dim() != 2 or tuple(offsets.shape) != tuple(lengths.shape)
            or lengths.shape[1] <= EXCEPTIONS or lengths.shape[0] < 1):
        raise ValueError(f"{name}: lengths and offsets must both be (C, E) "
                         f"with E > {EXCEPTIONS}, got {tuple(lengths.shape)} "
                         f"and {tuple(offsets.shape)}")
    if table.dim() != 1 or table.shape[0] < 1:
        raise ValueError(f"{name}: table must be (T,) with T >= 1, got "
                         f"{tuple(table.shape)}")
    for x in (cw, w_valid, n, ctx, lengths, offsets, table):
        if x.dtype != torch.int32 or x.device != cw.device:
            raise ValueError(f"{name}: every tensor must be int32 on "
                             f"{cw.device}, got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")


def decode_units(
    cw: torch.Tensor,  # (B, W) int32 token values
    w_valid: torch.Tensor,  # (B,) int32 valid token count per unit
    n: torch.Tensor,  # (B,) int32 ints to produce per unit
    ctx: torch.Tensor,  # (B,) int32 dictionary context per unit, in [0, C)
    lengths: torch.Tensor,  # (C, E) int32 entry lengths
    offsets: torch.Tensor,  # (C, E) int32 entry table offsets
    table: torch.Tensor,  # (T,) int32 flat table, u32 bits, zero padded
    *,
    b: int = 16,
    n_out: int = 256,
    assume_clean: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """X3: decode a bucket of units, returning what
    ``decode_units_plain`` returns ((B, n_out) int32 u32 values, (B,)
    produced, (B,) consumed).  On a CUDA device ONE launch of
    ``dint_raw_decode`` into fresh outputs (or the call raises); on the
    CPU the plain version."""
    _x3_check(cw, w_valid, n, ctx, lengths, offsets, table, b, n_out)
    dev = cw.device
    if dev.type == "cpu":
        return decode_units_plain(cw, w_valid, n, ctx, lengths, offsets,
                                  table, b=b, n_out=n_out,
                                  assume_clean=assume_clean)
    if dev.type != "cuda":
        raise ValueError(f"decode_units: unsupported device {dev}")
    B, W = cw.shape
    # the three outputs in one allocation: val, then produced, consumed
    buf = torch.empty(B * (n_out + 2), dtype=torch.int32, device=dev)
    val = buf[: B * n_out].view(B, n_out)
    produced = buf[B * n_out : B * (n_out + 1)]
    consumed = buf[B * (n_out + 1) :]
    if B == 0:
        return val, produced, consumed
    from . import cuda_ext

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_ext.lib(_X3_LIB).dint_raw_decode(
        cw.data_ptr(), w_valid.data_ptr(), n.data_ptr(), ctx.data_ptr(),
        lengths.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        val.data_ptr(), produced.data_ptr(), consumed.data_ptr(), B, W,
        lengths.shape[1], table.shape[0], n_out, b, int(assume_clean),
        stream)
    cuda_ext.check(_X3_LIB, "dint_raw_decode", rc)
    decode_units.launches += 1
    return val, produced, consumed


decode_units.launches = 0

KERNELS = {"X3_raw_decode": decode_units}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


def tokens_from_arena(
    arena_u8: np.ndarray, starts: np.ndarray, W: int, b: int
) -> np.ndarray:
    """Host-side token view: (B, W) int32 tokens for units at byte starts.

    Tokens are little-endian u16 (b=16) or u8 (b=8) read at
    ``starts[i] + tw*q`` — list payloads are NOT required to be aligned
    (the reference's streams aren't).
    """
    tw = b // 8
    starts = np.asarray(starts, dtype=np.int64)[:, None]
    q = np.arange(W, dtype=np.int64)[None, :]
    base = starts + tw * q
    base = np.minimum(base, arena_u8.shape[0] - tw)
    lo = arena_u8[base].astype(np.int32)
    if tw == 1:
        return lo
    hi = arena_u8[base + 1].astype(np.int32)
    return lo | (hi << 8)
