"""Whole-list Elias-Fano decode on ``device``.

The port of ``dint_tpu/codecs/ef_device.py``.  Decode semantics of
compact_elias_fano (compact_elias_fano.hpp:138-417, materialized
whole-list like ``codecs/ef.py::compact_elias_fano.decode_all``):
``value[i] = ((select_1(i) - i - 1) << w) | low[i]``.

Every list of a call decodes in one pass over one upload of the u32
words (no grouping by shape, no padding), into one int32 tensor holding
the u32 values in list order.  On the card that pass is X2, the hand
kernels of ``kernels/csrc/ef_decode.cu`` (``decode_tensors``): the
lists' high regions in list order form one sequence of words, whose
ones, counted in that order, are the output indices; ``prepare`` lays
that sequence out with each word masked to its region, a bit a word
where a list starts, a row a list and the row of each block's first
word; a count launch gives the ones of each block of ``BLOCK_WORDS``
words, a cumulative sum of one int a block its first output, and a
decode launch enumerates every word's ones with their low fields.
``decode_lists`` downloads the values through a pinned buffer kept for
the card and converts each list to uint64.

``decode_tensors_plain`` is its plain version, which the CPU runs, as
torch ops in int64 (values below 2**32, every right shift acts on
non-negative numbers, so no shift is arithmetic):

* LOW fields: output i of a list reads bits ``lbo + i*w`` .. ``+w`` with
  a gather of the two u32 words that hold them, joined in int64 and
  masked.
* HIGH bits (select_1): every list's high region is cut into its u32
  words, each masked to the region and popcounted; an inclusive
  cumulative sum over those counts ranks the words.  The region of a
  list holds exactly its n ones, so output g of the flat result (list
  L, position i) is the (g - word rank)-th one of the word that
  ``searchsorted`` finds for g, and a five-step binary search over
  popcounts of the word's halves finds that bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..kernels.decode_local import _to_i32
from . import ef as ef_mod

_M32 = 0xFFFFFFFF
_X2_LIB = "libdintef.so"
BLOCK_WORDS = 512  # high-region words of an X2 block (csrc/ef_decode.cu)
GUARD_WORDS = 3  # zero words after the arena: X2 reads low words ahead


def prepare(words: np.ndarray, specs: List[Tuple[int, int, int]],
            params: ef_mod.GlobalParameters) -> Dict[str, np.ndarray]:
    """Host half: the u32 words and each list's field geometry.

    specs: (offset_bits, universe, n) per list — the arguments
    ``compact_elias_fano.decode_all`` takes."""
    w32 = np.ascontiguousarray(words, dtype="<u8").view("<u4")
    L = len(specs)
    geo = np.zeros((5, L), np.int64)  # n, w, lbo, hbo, hbl
    for k, (off, universe, n) in enumerate(specs):
        assert universe < 1 << 32, "device EF decode is u32-valued"
        if n == 0:
            continue
        of = ef_mod.ef_offsets(off, universe, n, params)
        geo[:, k] = (of.n, of.lower_bits, of.lower_bits_offset,
                     of.higher_bits_offset, of.higher_bits_length)
    n, hbo, hbl = geo[0], geo[3], geo[4]
    hwc = np.where(n > 0, ((hbo + hbl - 1) >> 5) - (hbo >> 5) + 1, 0)
    # the sequence of every list's high words in list order, each masked to
    # its region, and X2's tables over it: a bit a word where a list with
    # values starts, a row a list with values (its first word, its first
    # output, lbo, w | (hbo & 31) << 8), and the row of each block's first
    # word (a block takes BLOCK_WORDS words)
    wend = np.cumsum(hwc)
    wstart = wend - hwc
    nw = int(wend[-1]) if L else 0
    live = np.flatnonzero(n > 0)
    high = w32[np.arange(nw) + np.repeat((hbo >> 5) - wstart, hwc)]
    # a region's first and last words hold bits of its neighbours
    end = hbo[live] + hbl[live]
    high[wstart[live]] &= ((_M32 << (hbo[live] & 31)) & _M32).astype("<u4")
    high[wend[live] - 1] &= (_M32 >> ((-end) & 31)).astype("<u4")
    starts = np.zeros(-(-nw // 32) * 32, np.uint8)
    starts[wstart[live]] = 1
    out_start = np.cumsum(n) - n
    lists = np.stack([wstart[live], out_start[live], geo[2][live],
                      geo[1][live] | ((hbo[live] & 31) << 8)], axis=1)
    # the list holding sequence word g: the first whose words end past g
    block_list = np.searchsorted(wend[live], np.arange(0, nw, BLOCK_WORDS),
                                 side="right")
    guard = np.zeros(GUARD_WORDS, "<u4")
    return {"words": np.concatenate([w32, guard]).view("<i4"),
            "high": high.view("<i4"),
            "starts": np.packbits(starts, bitorder="little").view("<i4"),
            "lists": np.ascontiguousarray(lists, np.int64),
            "block_list": block_list.astype(np.int64),
            "geo": geo, "hwc": hwc, "out_start": out_start,
            "sizes": (int(n.sum()), nw)}


def upload(prep: Dict, device) -> Dict:
    """The words, the geometry and the block table as tensors on
    ``device``; the two sizes stay host ints, so the decode needs no
    sync."""
    d = resolve_device(device)
    out = {k: torch.from_numpy(prep[k]).to(d)
           for k in ("words", "high", "starts", "lists", "block_list", "geo",
                     "hwc", "out_start")}
    out["sizes"] = prep["sizes"]
    return out


def _popcount(v: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values below 2**32 (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _select_in_word(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Bit index of the r-th (0-based) set bit of each u32 value x."""
    pos = torch.zeros_like(x)
    for width in (16, 8, 4, 2, 1):
        c = _popcount((x >> pos) & ((1 << width) - 1))
        go = r >= c
        r = torch.where(go, r - c, r)
        pos = torch.where(go, pos + width, pos)
    return pos


def decode_tensors_plain(t: Dict) -> torch.Tensor:
    """X2's plain version: every list's values, concatenated in list
    order, as int32 holding the u32 bits (torch ops in int64)."""
    words, hwc = t["words"], t["hwc"]
    n, w, lbo, hbo, hbl = t["geo"].unbind(0)
    total, nw = t["sizes"]
    dev = words.device
    L = n.shape[0]
    lists = torch.arange(L, device=dev)
    out_start = torch.cumsum(n, 0) - n
    lid = torch.repeat_interleave(lists, n, output_size=total)
    g = torch.arange(total, device=dev)
    i = g - out_start[lid]
    wl = w[lid]

    def word(j):
        return words[j].to(torch.int64) & _M32

    # low fields
    p = lbo[lid] + i * wl
    j = p >> 5
    # a field ends at bit 61 of the pair at most (w <= 31, offset <= 31):
    # the next word's top bit is dropped so the pair stays non-negative
    pair = word(j) | ((word(j + 1) & 0x7FFFFFFF) << 32)
    low = (pair >> (p & 31)) & ((torch.ones_like(wl) << wl) - 1)

    # high region words of every list, in list order
    hw0 = hbo >> 5
    wl_id = torch.repeat_interleave(lists, hwc, output_size=nw)
    wstart = torch.cumsum(hwc, 0) - hwc
    hj = hw0[wl_id] + (torch.arange(nw, device=dev) - wstart[wl_id])
    bit0 = hj << 5
    lo_cut = (hbo[wl_id] - bit0).clamp(0, 32)
    hi_cut = (hbo[wl_id] + hbl[wl_id] - bit0).clamp(0, 32)
    one = torch.ones_like(bit0)
    masked = word(hj) & ((one << hi_cut) - (one << lo_cut))
    pc = _popcount(masked)
    c_incl = torch.cumsum(pc, 0)
    wsel = torch.searchsorted(c_incl, g, right=True)
    r = g - (c_incl[wsel] - pc[wsel])
    rel = bit0[wsel] + _select_in_word(masked[wsel], r) - hbo[lid]
    high = rel - i - 1
    return _to_i32((high << wl) | low)


def decode_tensors(t: Dict) -> torch.Tensor:
    """X2, the device half: every list's values, concatenated in list
    order, as int32 holding the u32 bits.  On a CUDA device the count
    and decode launches of ``csrc/ef_decode.cu`` around a cumulative sum
    of one int a block (or the call raises); on the CPU
    ``decode_tensors_plain``."""
    name = "ef_decode"
    words = t["words"]
    dev = words.device
    if dev.type == "cpu":
        return decode_tensors_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    total, nw = t["sizes"]
    B = -(-nw // BLOCK_WORDS)
    for k, dtype, shape in (("words", torch.int32, None),
                            ("high", torch.int32, (nw,)),
                            ("starts", torch.int32, (-(-nw // 32),)),
                            ("lists", torch.int64, None),
                            ("block_list", torch.int64, (B,))):
        x = t[k]
        if x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous {dtype} on "
                             f"{dev}, got {x.dtype} on {x.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: {k} must be {shape}, got "
                             f"{tuple(x.shape)}")
    if t["lists"].dim() != 2 or t["lists"].shape[1] != 4:
        raise ValueError(f"{name}: lists must be (lists with values, 4), got "
                         f"{tuple(t['lists'].shape)}")
    out = torch.empty(total, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    from ..kernels import cuda_ext

    lib = cuda_ext.lib(_X2_LIB)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = torch.empty(B, dtype=torch.int64, device=dev)
    cuda_ext.check(_X2_LIB, "dint_ef_count", lib.dint_ef_count(
        t["high"].data_ptr(), counts.data_ptr(), B, nw, stream))
    incl = torch.cumsum(counts, 0)
    cuda_ext.check(_X2_LIB, "dint_ef_decode", lib.dint_ef_decode(
        words.data_ptr(), t["high"].data_ptr(), t["starts"].data_ptr(),
        t["block_list"].data_ptr(), t["lists"].data_ptr(), incl.data_ptr(),
        counts.data_ptr(), out.data_ptr(), B, nw, stream))
    decode_tensors.launches += 1
    return out


decode_tensors.launches = 0

KERNELS = {"X2_ef_decode": decode_tensors}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    """Calls of X2 that launched its two passes."""
    return {k: w.launches for k, w in KERNELS.items()}


_PINNED: Dict[int, torch.Tensor] = {}  # a card's index -> its host buffer


def download(flat: torch.Tensor) -> np.ndarray:
    """The u32 values of ``flat`` (int32 bits) on the host.  From a card
    through one pinned buffer kept for that card and grown to the
    largest download (a non-blocking copy, then a sync of the stream),
    so the array returned holds until the next download from that card;
    from the CPU the tensor's own memory."""
    if flat.device.type == "cpu":
        return flat.numpy().view(np.uint32)
    n = flat.numel()
    buf = _PINNED.get(flat.device.index)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.int32, pin_memory=True)
        _PINNED[flat.device.index] = buf
    host = buf[:n]
    host.copy_(flat.reshape(-1), non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host.numpy().view(np.uint32)


def decode_lists(words: np.ndarray, specs: List[Tuple[int, int, int]],
                 params: ef_mod.GlobalParameters,
                 device="cuda") -> List[np.ndarray]:
    """Decode many EF lists from one u64-word arena on ``device``; each
    list comes back as its own host uint64 array, as the reference's
    do."""
    prep = prepare(words, specs, params)
    if not specs:
        return []
    flat = download(decode_tensors(upload(prep, device)))
    ends = np.cumsum(prep["geo"][0])
    return [v.astype(np.uint64) for v in np.split(flat, ends[:-1])]
