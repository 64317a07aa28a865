"""X2, the Elias-Fano decode kernel (``csrc/ef_decode.cu``), on the CPU.

The kernel runs on the card only; here ``ef_device.decode_tensors``
takes its plain version, and a numpy mirror of the kernel's two passes
over ``prepare``'s chunks (pass 1: each chunk's ones; a cumulative sum;
pass 2: a block's exclusive scan of its words' popcounts, then each
word's ones enumerated lowest first with their low fields) stands in for
the launches.  Inputs are made with numpy from a seed; each list is held
exactly to the reference's ``ef_device.decode_lists`` (JAX on the CPU)
and to ``compact_elias_fano.decode_all``: lists with n = 0, w = 0, high
regions that start and end inside one word, values with bit 31 set and
one list spanning many chunks beside short ones.
"""

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


def mirror_decode(prep):
    """The kernel's two passes in numpy.  Returns (the flat u32 outputs,
    the words each chunk read, how often each output was written)."""
    words = prep["words"].view(np.uint32).astype(np.int64)
    n, w, lbo, hbo, hbl = prep["geo"]
    chunks = prep["chunks"]
    total = prep["sizes"][0]
    C = chunks.shape[0]

    def region(c):
        lst, w0 = chunks[c]
        last = (hbo[lst] + hbl[lst] - 1) >> 5
        j = w0 + np.arange(min(t_efd.CHUNK_WORDS, last - w0 + 1))
        lo = np.clip(hbo[lst] - (j << 5), 0, 32)
        hi = np.clip(hbo[lst] + hbl[lst] - (j << 5), 0, 32)
        mask = ((1 << hi) - 1) & ~((1 << lo) - 1)
        return j, words[j] & mask

    # pass 1, then the scan over one int a chunk
    counts = np.asarray([popcount(region(c)[1]).sum() for c in range(C)],
                        np.int64)
    incl = np.cumsum(counts)
    out = np.zeros(total, np.uint64)
    writes = np.zeros(total, np.int64)
    seen = []
    for c in range(C):  # pass 2, a block a chunk
        lst = chunks[c][0]
        j, x = region(c)
        seen.append((lst, j))
        pc = popcount(x)
        off = np.cumsum(pc) - pc  # the block's exclusive scan
        g0 = incl[c] - counts[c]
        for t in range(j.shape[0]):  # a thread a word
            i = g0 - prep["out_start"][lst] + off[t]
            xv = int(x[t])
            slot = g0 + off[t]
            while xv:
                b = (xv & -xv).bit_length() - 1  # __ffs - 1
                xv &= xv - 1
                high = ((j[t] << 5) - hbo[lst] + b - i - 1) & MASK
                low = 0
                if w[lst]:
                    p = lbo[lst] + i * w[lst]
                    pair = words[p >> 5] | (words[(p >> 5) + 1] << 32)
                    low = (pair >> (p & 31)) & ((1 << w[lst]) - 1)
                out[slot] = ((high << w[lst]) | low) & MASK
                writes[slot] += 1
                slot += 1
                i += 1
    return out.astype(np.uint32), seen, writes


@pytest.mark.parametrize("lead", [0, 37])
def test_mirror_equals_reference_and_host(lead):
    words, specs, vals = arena(lead)
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    got, seen, writes = mirror_decode(prep)
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
    # every high word of every list read by exactly one chunk
    for k in range(len(specs)):
        js = np.concatenate([j for lst, j in seen if lst == k] or [[]])
        np.testing.assert_array_equal(
            js, (prep["geo"][3][k] >> 5) + np.arange(prep["hwc"][k]))


def test_arena_holds_the_edge_cases():
    """The arena has what the kernel must get right: w = 0, an empty
    list, a high region inside one word, a list of many chunks beside
    one-chunk lists, values with bit 31 set."""
    words, specs, vals = arena()
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    n, w, _, hbo, hbl = prep["geo"]
    live = n > 0
    assert (w[live] == 0).any() and (~live).any()
    inside = live & ((hbo >> 5) == ((hbo + hbl - 1) >> 5))
    assert inside.any()
    per = np.bincount(prep["chunks"][:, 0], minlength=len(specs))
    assert per.max() >= 3 and (per[live] == 1).any()
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


def test_prepare_chunks_cover_each_region():
    """prepare's chunk table: chunks in list order, CHUNK_WORDS words
    apart inside a list, as many as the list's high words need, none
    for an empty list; out_start the running sum of n."""
    words, specs, _ = arena(lead=5)
    prep = t_efd.prepare(words, specs, t_ef.PARAMS)
    n, hwc = prep["geo"][0], prep["hwc"]
    c_list, c_w0 = prep["chunks"].T
    assert (np.diff(c_list) >= 0).all()
    np.testing.assert_array_equal(
        np.bincount(c_list, minlength=len(specs)),
        -(-hwc // t_efd.CHUNK_WORDS))
    first = np.searchsorted(c_list, c_list)
    np.testing.assert_array_equal(
        c_w0, (prep["geo"][3][c_list] >> 5)
        + (np.arange(c_list.size) - first) * t_efd.CHUNK_WORDS)
    np.testing.assert_array_equal(prep["out_start"], np.cumsum(n) - n)
    t_efd.reset_launch_counts()
    t_efd.decode_tensors(t_efd.upload(prep, "cpu"))
    assert t_efd.launch_counts() == {"X2_ef_decode": 0}
