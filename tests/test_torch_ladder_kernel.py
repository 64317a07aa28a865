"""X1, the fused ladder unpack (``csrc/ladder_unpack.cu``), on the CPU.

The kernel runs on the card only; here its wrappers take their plain
version, and a numpy mirror of the kernel's class table and per-block
index math stands in for the launch.  Inputs are made with numpy from a
seed; every comparison is exact (integers):

* ``ladder_unpack`` over ``LadderClasses`` against the reference's
  ``_fns``/``_fns_base`` (jitted on CPU JAX) at every ladder width, pfor
  and pforb, with a lane grid height M that is no multiple of a block's
  words, salts 0, 1 and 0xFFFFFFFF and words with bit 31 set;
* the mirror of ``dint_ladder_unpack`` and ``dint_ladder_rows`` covers
  every word exactly once, writes every output once, and equals the
  reference's outputs (the reference's packing for the rows entry);
* the CPU paths of the ladder engine, the sharded step and the EF
  decode never load ``cuda_ext``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.kernels import unpack_device as j_ud
from dint_tpu_torch.config import BLOCK_SIZE
from dint_tpu_torch.kernels import unpack_device as t_ud

MASK = 0xFFFFFFFF
SALTS = (0, 1, 0xFFFFFFFF)
LADDER = t_ud._LADDER
THREADS = 256


def class_inputs(w, rows, seed, base=True):
    """(words (W', M, 128) u32, bT (M, 128) u32) of ``rows`` blocks of
    width ``w``: fields at their maximum, bit 31 set in the top field,
    bases near 2^32 so that base + field + salt wraps."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << w, size=(rows, BLOCK_SIZE), dtype=np.uint64)
    vals[:, ::7] = (1 << w) - 1
    vals[:, 32 // w - 1 :: 32 // w] |= 1 << (w - 1)  # the word's top field
    words = j_ud._lane_major(j_ud._pack_w(vals.astype(np.uint32), w))
    b = rng.integers(0, 1 << 32, size=rows, dtype=np.uint64)
    b[:3] = (MASK, 1 << 31, 0)
    bT = j_ud._lane_major(b.astype(np.uint32)[:, None])[0]
    return words, (bT if base else None)


def to_i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def salt64(s):
    return torch.tensor([s], dtype=torch.int64)


def reference_out(w, words, bT, salt):
    if bT is None:
        return np.asarray(j_ud._fns(w)[0](jnp.asarray(words), None,
                                          jnp.uint32(salt)))
    return np.asarray(j_ud._fns_base(w)[0](jnp.asarray(words),
                                           jnp.asarray(bT), jnp.uint32(salt)))


# rows of each width's two classes: a ragged lane grid (M = 3 with 300
# blocks, M = 1 with 5), so that a class's words are no multiple of a
# block's 1024
ROWS = {"pfor": 300, "pforb": 5}


def mixed_classes(seed=0):
    """[(w, words, bT or None)] for every ladder width, pfor and pforb
    interleaved, as an engine's class list would be."""
    out = []
    for i, w in enumerate(LADDER):
        for kind, rows in ROWS.items():
            words, bT = class_inputs(w, rows, seed + 17 * i + len(kind),
                                     base=kind == "pforb")
            out.append((w, words, bT))
    return out


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("w", LADDER)
def test_ladder_unpack_equals_reference_fns(w, salt):
    """One LadderClasses of a pfor and a pforb class of width ``w``: the
    wrapper's outputs (the plain version on the CPU) equal the
    reference's _fns and _fns_base, and are rewritten in place."""
    classes = [(w, *class_inputs(w, 300, w, base=False)),
               (w, *class_inputs(w, 5, w + 1, base=True))]
    lc = t_ud.LadderClasses(
        [(cw, to_i32(words), None if bT is None else to_i32(bT))
         for cw, words, bT in classes], torch.device("cpu"))
    outs = t_ud.ladder_unpack(lc, salt64(salt))
    assert outs is lc.outs
    for out, (cw, words, bT) in zip(outs, classes):
        assert out.dtype == torch.int32
        assert tuple(out.shape) == (words.shape[0], 32 // cw, *words.shape[1:])
        np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                      reference_out(cw, words, bT, salt))


def test_ladder_unpack_launches_nothing_on_the_cpu():
    t_ud.reset_launch_counts()
    w, words, bT = mixed_classes()[1]
    lc = t_ud.LadderClasses([(w, to_i32(words), to_i32(bT))],
                            torch.device("cpu"))
    t_ud.ladder_unpack(lc, salt64(1))
    t_ud.ladder_rows({8: torch.zeros((3, 64), dtype=torch.int32)})
    assert t_ud.launch_counts() == {"X1_ladder_unpack": 0,
                                    "X1_ladder_rows": 0,
                                    "X4_byteclass_unpack": 0}


def test_ladder_unpack_refuses_what_the_kernel_does_not_take():
    words, _ = class_inputs(4, 10, 3, base=False)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="not a ladder width"):
        t_ud.LadderClasses([(7, to_i32(words), None)], cpu)
    with pytest.raises(ValueError, match="W', M, 128"):
        t_ud.LadderClasses([(4, to_i32(words).reshape(-1, 64), None)], cpu)
    with pytest.raises(ValueError, match="bT must be"):
        t_ud.LadderClasses([(4, to_i32(words),
                             torch.zeros((2, 128), dtype=torch.int32))], cpu)
    with pytest.raises(ValueError, match="int32"):
        t_ud.LadderClasses([(4, to_i32(words).to(torch.int64), None)], cpu)
    with pytest.raises(ValueError, match="at most 32 classes"):
        t_ud.LadderClasses([(4, to_i32(words), None)] * 33, cpu)
    lc = t_ud.LadderClasses([(4, to_i32(words), None)], cpu)
    with pytest.raises(ValueError, match="int64"):
        t_ud.ladder_unpack(lc, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="words"):
        t_ud.ladder_rows({4: torch.zeros((3, 31), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# numpy mirrors of the two kernels' grids
# ---------------------------------------------------------------------------


def find_classes(table, blocks):
    """The kernels' find_class for every block index: the last class
    whose block0 is at most the block (classes in table order)."""
    c = np.zeros(blocks.shape[0], np.int64)
    for k in range(1, table.shape[0]):
        c = np.where(blocks >= table[k, 5], k, c)
    return c


def mirror_unpack(table, words, bases, salt):
    """dint_ladder_unpack in numpy: the grid the C entry launches (the
    last class's block0 plus its blocks), each block's class, each
    thread's four words q .. q + 3 at q = (block - block0) * 1024 + 4t,
    k = q // P and p = q % P, and the vpw stores of a thread at
    (k * vpw + r) * P + p.  Returns the outputs as flat u32 arrays and
    how often each word was read and each output written."""
    last = table[-1]
    grid = last[5] + -(-last[4] // t_ud.X1_WORDS_PER_BLOCK)
    block = np.repeat(np.arange(grid), THREADS)
    thread = np.tile(np.arange(THREADS), grid)
    cls = find_classes(table, block)
    q = (block - table[cls, 5]) * t_ud.X1_WORDS_PER_BLOCK + 4 * thread
    live = q < table[cls, 4]
    reads = [np.zeros(x.size, np.int64) for x in words]
    outs = [np.zeros(x.size * (32 // int(w)), np.uint64)
            for x, w in zip(words, table[:, 6])]
    writes = [np.zeros(o.size, np.int64) for o in outs]
    for c in range(table.shape[0]):
        P, w = int(table[c, 3]), int(table[c, 6])
        vpw = 32 // w
        qc = q[live & (cls == c)]
        for e in range(4):  # the four words of a 16-byte load
            qe = qc + e
            np.add.at(reads[c], qe, 1)
            k, p = qe // P, qe % P
            x = words[c].reshape(-1)[qe].astype(np.uint64)
            add = np.uint64(salt)
            if bases[c] is not None:
                add = add + bases[c].reshape(-1)[p].astype(np.uint64)
            for r in range(vpw):
                o = (k * vpw + r) * P + p
                np.add.at(writes[c], o, 1)
                field = (x >> np.uint64(r * w)) & np.uint64((1 << w) - 1)
                outs[c][o] = (field + add) & np.uint64(MASK)
    return [o.astype(np.uint32) for o in outs], reads, writes


@pytest.mark.parametrize("salt", SALTS)
def test_unpack_grid_mirror_covers_every_word_once(salt):
    """Every ladder width, pfor and pforb, in one table: the mirror of
    the launch reads each word once, writes each output once, and its
    outputs equal the reference's _fns/_fns_base."""
    classes = mixed_classes(seed=salt & 7)
    geometry = [(w, words.shape[1] * 128, words.size, words.size)
                for w, words, _ in classes]
    table = t_ud.ladder_table(geometry, t_ud.X1_WORDS_PER_BLOCK)
    # the engine's own table carries the same geometry
    lc = t_ud.LadderClasses(
        [(w, to_i32(words), None if bT is None else to_i32(bT))
         for w, words, bT in classes], torch.device("cpu"))
    np.testing.assert_array_equal(lc.table, table)
    assert not lc.table[:, :3].any()  # no pointer on the CPU
    outs, reads, writes = mirror_unpack(
        table, [c[1] for c in classes], [c[2] for c in classes], salt)
    for (w, words, bT), out, rd, wr in zip(classes, outs, reads, writes):
        assert (rd == 1).all() and (wr == 1).all()
        want = reference_out(w, words, bT, salt)
        np.testing.assert_array_equal(out.reshape(want.shape), want)


def test_unpack_table_blocks_follow_the_classes():
    """block0 is the running sum of each class's blocks, a class with
    one lane grid (M = 1) takes one block or more, and the grid the C
    entry computes from the last row holds every class."""
    words = [-(-BLOCK_SIZE // (32 // w)) * 128 for w in LADDER]  # M = 1
    geometry = [(w, 128, n, n) for w, n in zip(LADDER, words)]
    table = t_ud.ladder_table(geometry, t_ud.X1_WORDS_PER_BLOCK)
    blocks = [-(-g[3] // 1024) for g in geometry]
    np.testing.assert_array_equal(table[:, 5], np.cumsum(blocks) - blocks)
    assert table[-1, 5] + blocks[-1] == sum(blocks)
    np.testing.assert_array_equal(table[:, 6], LADDER)
    # W' = 8 words a block at w = 1: one grid row of 8 * 128 words
    assert table[0, 4] == 8 * 128


def mirror_rows(table, packed):
    """dint_ladder_rows in numpy: four rows a block, 64 threads a row,
    thread t of a row writing values 4t .. 4t + 3, value j from word
    j // vpw at shift (j % vpw) * w."""
    last = table[-1]
    grid = last[5] + -(-last[3] // t_ud.X1_ROWS_PER_BLOCK)
    block = np.repeat(np.arange(grid), THREADS)
    thread = np.tile(np.arange(THREADS), grid)
    cls = find_classes(table, block)
    row = (block - table[cls, 5]) * t_ud.X1_ROWS_PER_BLOCK + thread // 64
    live = row < table[cls, 3]
    outs, writes = {}, {}
    for c in range(table.shape[0]):
        w = int(table[c, 6])
        vpw = 32 // w
        a = packed[w].astype(np.uint64)
        out = np.zeros((a.shape[0], BLOCK_SIZE), np.uint64)
        wr = np.zeros(out.shape, np.int64)
        sel = live & (cls == c)
        r, j0 = row[sel], (thread[sel] % 64) * 4
        for e in range(4):
            j = j0 + e
            np.add.at(wr, (r, j), 1)
            sh = (j % vpw * w).astype(np.uint64)
            out[r, j] = (a[r, j // vpw] >> sh) & np.uint64((1 << w) - 1)
        outs[w], writes[w] = out.astype(np.uint32), wr
    return outs, writes


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_grid_mirror_equals_the_reference_packing(seed):
    """The rows entry over every width (block counts no multiple of a
    block's four rows, one width with a single row): the mirror writes
    each value once and gives back the values the reference's _pack_w
    packed; the wrapper's plain version (the sharded step on the CPU)
    equals both."""
    rng = np.random.default_rng(seed)
    vals, packed = {}, {}
    for i, w in enumerate(LADDER):
        rows = 1 if i == 3 else int(rng.integers(2, 11))
        v = rng.integers(0, 1 << w, size=(rows, BLOCK_SIZE), dtype=np.uint64)
        v[:, 32 // w - 1 :: 32 // w] |= 1 << (w - 1)
        vals[w] = v.astype(np.uint32)
        packed[w] = j_ud._pack_w(vals[w], w)
    table = t_ud.ladder_table(
        [(w, a.shape[0], a.shape[1], a.shape[0]) for w, a in packed.items()],
        t_ud.X1_ROWS_PER_BLOCK)
    outs, writes = mirror_rows(table, packed)
    got = t_ud.ladder_rows({w: to_i32(a) for w, a in packed.items()})
    for w in LADDER:
        assert (writes[w] == 1).all()
        np.testing.assert_array_equal(outs[w], vals[w])
        np.testing.assert_array_equal(got[w].numpy().view(np.uint32), vals[w])


def rank_views(seed, ranks=3, rows=5):
    """One (ranks, rows, words_w) tensor a width, as a caller uploads the
    whole sharded pack, and the values each rank's rows hold: {w:
    (tensor, values (ranks, rows, 256) u32)}.  Odd ``rows`` put rank
    1's slice at an offset that is no multiple of 16 B for most
    widths."""
    rng = np.random.default_rng(seed)
    out = {}
    for w in LADDER:
        v = rng.integers(0, 1 << w, size=(ranks * rows, BLOCK_SIZE),
                         dtype=np.uint64)
        v[:, 32 // w - 1 :: 32 // w] |= 1 << (w - 1)
        v = v.astype(np.uint32)
        words = j_ud._pack_w(v, w).reshape(ranks, rows, -1)
        out[w] = (to_i32(words), v.reshape(ranks, rows, BLOCK_SIZE))
    return out


def view_cases(whole):
    """(label, {w: view}, {w: row index into each rank's rows}): rank 1's
    slice (an offset view), that slice from its second row (offsets
    that are no multiple of 16 B), every other row of it (not
    contiguous), and a column-major copy read through its transpose."""
    return [
        ("rank 1", {w: a[1] for w, (a, _) in whole.items()}, slice(None)),
        ("rank 1 from row 1", {w: a[1][1:] for w, (a, _) in whole.items()},
         slice(1, None)),
        ("every other row", {w: a[1][::2] for w, (a, _) in whole.items()},
         slice(None, None, 2)),
        ("transposed copy", {w: a[1].t().contiguous().t()
                             for w, (a, _) in whole.items()}, slice(None)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_rows_entry_decodes_any_view(case):
    """ladder_rows takes any int32 (NBw, words_w) view, as the reference's
    sharded step takes any array: an offset slice of one uploaded
    tensor, unaligned, strided or transposed, decodes to the values the
    reference packed (the CPU path; the card's in
    ``tests/test_torch_card.py`` and chip_smoke.py phase 17)."""
    whole = rank_views(case)
    label, views, rows = view_cases(whole)[case]
    if case >= 2:
        assert not any(v.is_contiguous() for v in views.values()), label
    got = t_ud.ladder_rows(views)
    for w, (_, vals) in whole.items():
        np.testing.assert_array_equal(got[w].numpy().view(np.uint32),
                                      vals[1][rows], err_msg=f"{label} w={w}")
        np.testing.assert_array_equal(
            t_ud.ladder_rows_plain(views[w], w).numpy(), got[w].numpy())


def test_rows_entry_still_refuses_wrong_dtype_and_device():
    whole = rank_views(9)
    with pytest.raises(ValueError, match="int32"):
        t_ud.ladder_rows({8: whole[8][0][1].to(torch.int64)})
    with pytest.raises(ValueError, match="int32 on"):
        t_ud.ladder_rows({8: whole[8][0][1],
                          16: whole[16][0][1].to("meta")})


# ---------------------------------------------------------------------------
# the CPU paths never reach the kernel libraries
# ---------------------------------------------------------------------------


def test_cpu_paths_never_load_cuda_ext(monkeypatch):
    """The ladder engine (decode, chain), the sharded rows entry and the
    EF decode on the CPU run their plain versions: nothing builds or
    loads a kernel library."""
    from dint_tpu.codecs import ef as j_ef
    from dint_tpu_torch.codecs import ef as t_ef
    from dint_tpu_torch.codecs import ef_device as t_efd
    from dint_tpu_torch.kernels import cuda_ext
    from dint_tpu_torch.utils.bitio import BitBuilder

    def refuse(*a, **k):
        raise AssertionError("a CPU path reached cuda_ext")

    monkeypatch.setattr(cuda_ext, "lib", refuse)
    monkeypatch.setattr(cuda_ext, "build", refuse)
    flat = np.random.default_rng(5).integers(0, 1 << 20, 256 * 9 + 40,
                                             dtype=np.uint64)
    flat = flat.astype(np.uint32)
    for rel in (False, True):
        plan = t_ud.ladder_plan_from_values(flat, base_relative=rel,
                                            native=False)
        eng = t_ud.UnpackEngine(plan, device="cpu")
        np.testing.assert_array_equal(eng.decode_all_ordered(), flat)
        eng.chain(2)
    t_ud.ladder_rows({16: torch.zeros((2, 128), dtype=torch.int32)})
    bb = BitBuilder()
    v = np.arange(0, 3000, 7, dtype=np.uint64)
    t_ef.compact_elias_fano.write(bb, v, 3000, v.size, t_ef.PARAMS)
    got = t_efd.decode_lists(bb.words(), [(0, 3000, v.size)], t_ef.PARAMS,
                             device="cpu")
    np.testing.assert_array_equal(got[0], v)
    np.testing.assert_array_equal(
        got[0], j_ef.compact_elias_fano.decode_all(bb.words(), 0, 3000,
                                                   v.size, j_ef.PARAMS))
