"""X2, the Elias-Fano decode kernel (``csrc/ef_decode.cu``), on the CPU.

The kernel runs on the card only; here ``ef_device.decode_tensors``
takes its plain version, and a numpy mirror of the kernel's two passes
over ``prepare``'s tables stands in for the launches: pass 1 counts the
ones of each block of BLOCK_WORDS words of the sequence of every list's
high words (each word masked to its region) and their running sum gives
each block's first output; pass 2, block by block in any order, finds
each word's list from the block's first list and the start bits, and
enumerates each word's ones lowest first with their low fields (read in
order through a window of four words), round by round through a staging
buffer.  Inputs are made with numpy from a seed; each list is held
exactly to the reference's ``ef_device.decode_lists`` (JAX on the CPU)
and to ``compact_elias_fano.decode_all``: lists with n = 0, w = 0, high
regions that start and end inside one word, values with bit 31 set, one
list longer than a block beside short ones, and many short lists a
block.
"""

import os
import re

import numpy as np
import pytest
import torch

from dint_tpu.codecs import ef as j_ef
from dint_tpu.codecs import ef_device as j_efd
from dint_tpu_torch.codecs import ef as t_ef
from dint_tpu_torch.codecs import ef_device as t_efd
from dint_tpu_torch.utils.bitio import BitBuilder

MASK = 0xFFFFFFFF


def values(n, universe, seed):
    """n sorted distinct values below ``universe``, the last at
    universe - 1."""
    if n == 0:
        return np.zeros(0, np.uint64)
    if n == universe:
        return np.arange(n, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    v = np.unique(rng.integers(0, universe - 1, n + n // 4 + 4,
                               dtype=np.uint64))[: n - 1]
    while v.size < n - 1:
        v = np.unique(np.concatenate([v, rng.integers(
            0, universe - 1, n, dtype=np.uint64)]))[: n - 1]
    return np.append(v, np.uint64(universe - 1))


# (n, universe): one value at w = 0; dense runs (w = 0); a region inside
# one word; universes past 2^31 and at 2^32 - 1 (bit 31 in the values);
# one list of many chunks; an empty list between others
LISTS = [(1, 1), (5, 5), (3, 9), (0, 100), (2, 40), (64, 64), (300, 330),
         (7, (1 << 32) - 1), (1000, (1 << 31) + 77), (0, 1 << 20),
         (70_000, 150_000), (33, 1 << 20), (256, 256), (4, 1 << 31)]


def arena(lead=37, lists=LISTS, seed=3):
    """(u64 words, specs, values) of ``lists`` written one after another
    from a misaligned start; an empty list gets a spec and no bits."""
    bb = BitBuilder()
    bb.append_bits(0x5A5A5 & ((1 << lead) - 1), lead)
    specs, vals = [], []
    for k, (n, universe) in enumerate(lists):
        v = values(n, universe, seed + k)
        specs.append((bb.size, universe, n))
        if n:
            t_ef.compact_elias_fano.write(bb, v, universe, n, t_ef.PARAMS)
        vals.append(v)
    return bb.words(), specs, vals


def popcount(x):
    x = x.astype(np.uint64)
    c = np.zeros(x.shape, np.int64)
    for b in range(32):
        c += ((x >> np.uint64(b)) & np.uint64(1)).astype(np.int64)
    return c


SRC = os.path.join(os.path.dirname(os.path.dirname(t_efd.__file__)),
                   "kernels", "csrc", "ef_decode.cu")


def constant(name):
    m = re.search(rf"constexpr int {name} = (\w+)( \* \w+)?;",
                  open(SRC).read())
    assert m, f"{name} not found in {SRC}"
    return m.group(0)


THREADS = int(re.search(r"(\d+)", constant("THREADS")).group(1))
ROUNDS = int(re.search(r"(\d+)", constant("ROUNDS")).group(1))
assert THREADS % 32 == 0


def short_lists(count=300, seed=5):
    """Many short lists, some empty, so that a block spans dozens."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        n = int(rng.integers(0, 12)) if k % 7 else 0
        out.append((n, int(rng.integers(max(n, 1), 1 << 16))))
    return out


def list_of_words(prep):
    """The list of each word of the sequence of high words."""
    return np.repeat(np.arange(prep["hwc"].shape[0]), prep["hwc"])


def start_flags(prep):
    """The ``starts`` bit of each sequence word."""
    bits = np.unpackbits(prep["starts"].view(np.uint8), bitorder="little")
    return bits[: prep["sizes"][1]].astype(np.int64)


def block_rows(prep, t):
    """Block t's row of ``lists`` for each of its BLOCK_WORDS words: the
    row of its first word, plus the start flags after it up to the word
    (the kernel's two warp-and-block scans; the first word's own flag
    aside)."""
    nw, bw = prep["sizes"][1], t_efd.BLOCK_WORDS
    flags = np.zeros(bw, np.int64)
    got = start_flags(prep)[t * bw : (t + 1) * bw]
    flags[: got.size] = got
    return prep["block_list"][t] + np.cumsum(flags) - flags[0]


def mirror_decode(prep, order=None):
    """The kernel's two passes in numpy, pass 2's blocks in ``order`` (any
    order: a block depends on pass 1 alone).  Returns (the flat u32
    outputs, the (list, arena word) each block read, how often each
    output was written)."""
    words = prep["words"].view(np.uint32).astype(np.int64)
    wstart, out_start, lbo, w_hbo = prep["lists"].T
    w, hbo31 = w_hbo & 0xFF, w_hbo >> 8
    live = np.flatnonzero(prep["geo"][0] > 0)  # the list of each row
    hbo = prep["geo"][3]
    total, nw = prep["sizes"]
    bw = t_efd.BLOCK_WORDS
    out = np.zeros(total, np.uint64)
    writes = np.zeros(total, np.int64)
    seen = []
    high = prep["high"].view(np.uint32).astype(np.int64)
    # pass 1: each block's ones; their running sum, each block's first
    # output (incl - counts)
    B = prep["block_list"].shape[0]
    counts = np.asarray([popcount(high[t * bw : (t + 1) * bw]).sum()
                         for t in range(B)], np.int64)
    starts_at = np.cumsum(counts) - counts
    for t in (range(B) if order is None else order(B)):
        gw = t * bw + np.arange(bw)
        inside = gw < nw
        lst = np.minimum(block_rows(prep, t), max(live.size - 1, 0))
        x = np.where(inside, high[np.minimum(gw, max(nw - 1, 0))], 0)
        kw = gw - wstart[lst]  # the word's place in its list's region
        seen.append((t, live[lst][inside],
                     ((hbo[live[lst]] >> 5) + kw)[inside]))
        pc = popcount(x)
        off = np.cumsum(pc) - pc
        before = int(starts_at[t])  # pass 1 and the running sum
        # round by round: each word's ones into the stage (its high part
        # dropping by one a value, its low fields read in order through a
        # window of four words), then the round's run of outputs in order
        for r in range(ROUNDS):
            rw = slice(r * THREADS, (r + 1) * THREADS)
            r0 = int(off[r * THREADS])
            stage = np.zeros(THREADS * 32, np.uint64)
            for p in range(r * THREADS, (r + 1) * THREADS):
                lp, xv = lst[p], int(x[p])
                if not xv:
                    continue
                i = before + int(off[p]) - out_start[lp]
                bit0 = (int(kw[p]) << 5) - hbo31[lp]
                hi_ = (bit0 - i - 1) & MASK
                q, sh = divmod(lbo[lp] + i * w[lp], 32)
                win = [words[q + d] for d in range(4)]  # a window of 4
                s_ = int(off[p]) - r0
                while xv:
                    if sh >= 32:
                        sh -= 32
                        q += 1
                        assert q + 3 < words.size  # the guard words at most
                        win = win[1:] + [words[q + 3]]
                    b = (xv & -xv).bit_length() - 1  # __ffs - 1
                    xv &= xv - 1
                    low = ((win[0] | (win[1] << 32)) >> sh) & ((1 << w[lp]) - 1)
                    stage[s_] = ((((hi_ + b) & MASK) << w[lp]) | low) & MASK
                    s_ += 1
                    hi_ -= 1
                    sh += w[lp]
            k = int(pc[rw].sum())
            out[before + r0 : before + r0 + k] = stage[:k]
            writes[before + r0 : before + r0 + k] += 1
    return out.astype(np.uint32), seen, writes


@pytest.mark.parametrize("lead,lists", [(0, LISTS), (37, LISTS),
                                        (11, short_lists())])
def test_mirror_equals_reference_and_host(lead, lists):
    words, specs, vals = arena(lead, lists)
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    got, seen, writes = mirror_decode(
        prep, lambda B: np.random.default_rng(lead).permutation(B))
    assert (writes == 1).all()
    flat = np.split(got, np.cumsum([n for _, _, n in specs])[:-1])
    live = [k for k, (_, _, n) in enumerate(specs) if n]
    ref = j_efd.decode_lists(words, [specs[k] for k in live], j_ef.PARAMS)
    for k, r in zip(live, ref):
        off, universe, n = specs[k]
        np.testing.assert_array_equal(flat[k], r, err_msg=f"list {k}")
        np.testing.assert_array_equal(flat[k], vals[k])
        np.testing.assert_array_equal(
            flat[k], j_ef.compact_elias_fano.decode_all(
                words, off, universe, n, j_ef.PARAMS))
    for k, (_, _, n) in enumerate(specs):
        if not n:
            assert flat[k].size == 0
    # every high word of every list read by exactly one block, in order
    seen = sorted(seen, key=lambda tb: tb[0])
    lst = np.concatenate([a for _, a, _ in seen])
    js = np.concatenate([b for _, _, b in seen])
    for k in range(len(specs)):
        np.testing.assert_array_equal(
            js[lst == k], (prep["geo"][3][k] >> 5) + np.arange(prep["hwc"][k]))


def test_arena_holds_the_edge_cases():
    """The arena has what the kernel must get right: w = 0, an empty
    list, a high region inside one word, a list longer than three blocks
    beside lists that share a block, values with bit 31 set."""
    words, specs, vals = arena()
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    n, w, _, hbo, hbl = prep["geo"]
    live = n > 0
    assert (w[live] == 0).any() and (~live).any()
    inside = live & ((hbo >> 5) == ((hbo + hbl - 1) >> 5))
    assert inside.any()
    assert prep["hwc"].max() >= 3 * t_efd.BLOCK_WORDS
    rows = np.diff(prep["block_list"])
    assert (rows == 0).any() and (rows >= 3).any()
    assert max(int(v.max()) for v in vals if v.size) >= 1 << 31


def test_plain_twin_is_int32_bits_in_list_order():
    """decode_tensors on CPU tensors is the plain version: one int32
    tensor of the u32 bits, every list in list order, equal to the
    reference's values."""
    words, specs, vals = arena()
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    t = t_efd.upload(prep, "cpu")
    flat = t_efd.decode_tensors(t)
    assert flat.dtype == torch.int32
    assert torch.equal(flat, t_efd.decode_tensors_plain(t))
    want = np.concatenate(vals).astype(np.uint32)
    np.testing.assert_array_equal(flat.numpy().view(np.uint32), want)
    assert (flat < 0).any()  # bit 31 survives as the sign bit


def test_decode_lists_on_cpu_with_empty_lists():
    words, specs, vals = arena()
    got = t_efd.decode_lists(words, specs, t_ef.PARAMS, device="cpu")
    assert len(got) == len(specs)
    for g, v in zip(got, vals):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, v)


@pytest.mark.parametrize("lead,lists", [(5, LISTS), (0, short_lists()),
                                        (3, [(0, 9), (0, 9)] + LISTS[10:11]
                                         + [(0, 9)] * 40 + [(2, 5)])])
def test_prepare_blocks_cover_each_high_word(lead, lists):
    """prepare's tables: BLOCK_WORDS words of the sequence of high words a
    block, the last one cut short; a start bit where each list with
    values begins, none for an empty list; a row of ``lists`` a list with
    values (its first word, first output, lbo, w and hbo & 31); the row
    of each block's first word.  The rows the kernel finds for a block's
    words (the block's row plus the start bits) are the lists those words
    belong to, so the blocks cover every high word exactly once, in list
    order, also across empty lists and a list longer than a block; the
    sequence holds each list's region words, masked to the region."""
    words, specs, _ = arena(lead, lists)
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    n, w, lbo, hbo, hbl = prep["geo"]
    hwc, bw = prep["hwc"], t_efd.BLOCK_WORDS
    total, nw = prep["sizes"]
    assert nw == hwc.sum() and total == n.sum()
    np.testing.assert_array_equal(hwc > 0, n > 0)
    live = np.flatnonzero(n > 0)
    wstart = np.cumsum(hwc) - hwc
    out_start = np.cumsum(n) - n
    np.testing.assert_array_equal(prep["out_start"], out_start)
    np.testing.assert_array_equal(
        prep["lists"], np.stack([wstart[live], out_start[live], lbo[live],
                                 w[live] | ((hbo[live] & 31) << 8)], 1))
    flags = start_flags(prep)
    assert flags.sum() == live.size
    np.testing.assert_array_equal(np.flatnonzero(flags), wstart[live])
    bl = prep["block_list"]
    assert bl.dtype == np.int64 and bl.shape == (-(-nw // bw),)
    owner = np.repeat(np.arange(live.size), hwc[live])  # row of each word
    found = np.concatenate([block_rows(prep, t)[: min(bw, nw - t * bw)]
                            for t in range(bl.shape[0])] or [[]])
    np.testing.assert_array_equal(found, owner)
    np.testing.assert_array_equal(bl, owner[::bw])
    # the sequence itself: each list's region words in order, masked to it
    w32 = prep["words"].view(np.uint32)
    assert (w32[-t_efd.GUARD_WORDS :] == 0).all()
    high = prep["high"].view(np.uint32)
    assert high.shape == (nw,)
    for l in live:
        bits = np.unpackbits(w32[(hbo[l] >> 5) + np.arange(hwc[l])]
                             .view(np.uint8), bitorder="little")
        region = np.zeros_like(bits)
        region[hbo[l] & 31 : (hbo[l] & 31) + hbl[l]] = 1
        got = np.unpackbits(high[wstart[l] : wstart[l] + hwc[l]]
                            .view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(got, bits & region, err_msg=f"list {l}")
    t_efd.reset_launch_counts()
    t_efd.decode_tensors(t_efd.upload(prep, "cpu"))
    assert t_efd.launch_counts() == {"X2_ef_decode": 0}


def test_kernel_block_words_match_the_host():
    """``ef_device.BLOCK_WORDS`` is the kernel's THREADS * ROUNDS."""
    assert t_efd.BLOCK_WORDS == THREADS * ROUNDS
    assert "BLOCK_WORDS = THREADS * ROUNDS" in constant("BLOCK_WORDS")


def test_decode_lists_gives_separate_uint64_arrays():
    """``decode_lists`` gives one uint64 array a list, equal to the values
    written, empty lists included, over the u32 values ``download``
    returns; no list shares memory with another or with those values, so
    a write into one list leaves every other as it was."""
    words, specs, vals = arena(lists=LISTS + short_lists(40))
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    flat = t_efd.decode_tensors(t_efd.upload(prep, "cpu"))
    host = t_efd.download(flat)
    assert host.dtype == np.uint32 and host.shape == (prep["sizes"][0],)
    np.testing.assert_array_equal(host, np.concatenate(vals).astype(np.uint32))
    got = t_efd.decode_lists(words, specs, t_ef.PARAMS, device="cpu")
    assert len(got) == len(specs)
    for g, v in zip(got, vals):
        assert g.dtype == np.uint64 and g.ndim == 1
        np.testing.assert_array_equal(g, v)
        assert not np.shares_memory(g, host)
    live = [g for g in got if g.size]
    for a in range(len(live)):
        for b in range(a + 1, len(live)):
            assert not np.shares_memory(live[a], live[b])
    keep = [g.copy() for g in got]
    live[0][:] = 7
    for g, k in zip(got[1:], keep[1:]):
        if g is not live[0]:
            np.testing.assert_array_equal(g, k)
