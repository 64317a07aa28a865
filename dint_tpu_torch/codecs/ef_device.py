"""Whole-list Elias-Fano decode on ``device`` (torch ops).

The port of ``dint_tpu/codecs/ef_device.py``.  Decode semantics of
compact_elias_fano (compact_elias_fano.hpp:138-417, materialized
whole-list like ``codecs/ef.py::compact_elias_fano.decode_all``):
``value[i] = ((select_1(i) - i - 1) << w) | low[i]``.

Every list of a call decodes in one flat pass of torch ops over one
upload of the u32 words (no grouping by shape, no padding):

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

All arithmetic on the u32 data is int64 (values below 2**32, every
right shift acts on non-negative numbers), so no shift is arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from . import ef as ef_mod

_M32 = 0xFFFFFFFF


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
    # one zero guard word: a low field may read the word after the last
    return {"words": np.concatenate([w32, np.zeros(1, "<u4")]).view("<i4"),
            "geo": geo, "hwc": hwc,
            "sizes": (int(n.sum()), int(hwc.sum()))}


def upload(prep: Dict, device) -> Dict:
    """The words and the geometry as tensors on ``device``; the two
    output sizes stay host ints, so the decode needs no sync."""
    d = resolve_device(device)
    out = {k: torch.from_numpy(prep[k]).to(d)
           for k in ("words", "geo", "hwc")}
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


def decode_tensors(t: Dict) -> torch.Tensor:
    """Device half: every list's values, concatenated in list order
    (int64, values below 2**32)."""
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
    return (high << wl) | low


def decode_lists(words: np.ndarray, specs: List[Tuple[int, int, int]],
                 params: ef_mod.GlobalParameters,
                 device="cuda") -> List[np.ndarray]:
    """Decode many EF lists from one u64-word arena on ``device``; each
    list comes back as a host uint64 array, as the reference's do."""
    prep = prepare(words, specs, params)
    if not specs:
        return []
    flat = decode_tensors(upload(prep, device)).cpu().numpy()
    ends = np.cumsum(prep["geo"][0])
    return [v.astype(np.uint64) for v in np.split(flat, ends[:-1])]
