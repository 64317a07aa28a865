"""X4, the byte-class wire unpack (``csrc/byteclass_unpack.cu``), on the
CPU.

The kernel runs on the card only; here ``byteclass_unpack`` takes its
plain version (``_byteclass_unpack`` class by class), and a numpy mirror
of the kernel's class table and grid partition stands in for the launch:
for every block its class (the ``block0`` prefix), for every thread its
four values, read as L little-endian words from a 4-byte boundary when
all four are in the class and byte by byte when the class ends first,
every group past bit 31 dropped.  The launch constants are read from the
``.cu`` source.  The mirror must write every value of every class once,
nothing else, and equal ``_byteclass_unpack`` and the reference's
(``dint_tpu/kernels/unpack_device.py`` ``_byteclass_unpack``), for the
plans of the five byte codecs built from a seeded collection and for
classes of every length 1-5 in both group widths (the fifth 7-bit group
keeps 4 bits, a fifth byte falls off), sizes that are no multiple of
four and empty classes.  The engine's chain checksum must equal a replay
of the reference's chain body.  Every comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import x4_edge_classes
from dint_tpu.index import stream as j_stream
from dint_tpu.index import vroom_zoo as j_vz
from dint_tpu.kernels import unpack_device as j_ud
from dint_tpu_torch.index import stream as t_stream
from dint_tpu_torch.kernels import unpack_device as t_ud

SRC = os.path.join(os.path.dirname(t_ud.__file__), "csrc",
                   "byteclass_unpack.cu")
TEXT = open(SRC).read()
BYTE_CODECS = ("vbyte", "maskedvbyte", "streamvbyte", "varintgb",
               "varintg8iu")
SALTS = (0, 1, 0xFFFFFFFF)
M32 = 0xFFFFFFFF


def constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", TEXT)
    assert m, f"{name} not found in {SRC}"
    return int(m.group(1))


THREADS = constant("THREADS")
VPT = constant("VALUES_PER_THREAD")
VPB = THREADS * VPT
MAX_CLASSES = constant("MAX_CLASSES")


def salt64(s):
    return torch.tensor([s], dtype=torch.int64)


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------


def add_group(v, byte, g, gb):
    mask = 0xFF if gb == 8 else 0x7F
    return v | (((byte & mask) << (gb * g)) & M32) if gb * g < 32 else v


def mirror_launch(bc, salt):
    """The launch over ``bc``'s table as the kernel runs it: (buffer
    (values,) u32 with the untouched slots at a sentinel, writes a
    slot)."""
    table = bc.table
    gb = bc.group_bits
    sizes = table[:, 2]
    lens = table[:, 3]
    block0 = table[:, 4]
    nb = len(table)
    blocks = int(block0[-1] + -(-sizes[-1] // VPB)) if nb else 0
    buf = np.full(bc.buf.shape[0], 0xDEADBEEF, np.uint64)
    writes = np.zeros(bc.buf.shape[0], np.int64)
    data = [b.numpy().reshape(-1) for _, b in bc.classes]
    for blk in range(blocks):
        c = 0
        while c + 1 < nb and blk >= block0[c + 1]:
            c += 1
        N, L, flat = int(sizes[c]), int(lens[c]), data[c]
        base = int(bc.offsets[c])
        i = (blk - int(block0[c])) * VPB + np.arange(THREADS) * VPT
        i = i[i < N]
        full = i[i + VPT <= N]
        if full.size:
            assert ((full * L) % 4 == 0).all()  # four values' words align
            if L <= 5:
                byts = flat[(full * L)[:, None] + np.arange(4 * L)[None, :]]
                words = np.ascontiguousarray(byts).view("<u4").astype(
                    np.uint64)  # (threads, L)
                for e in range(VPT):
                    v = np.zeros(full.size, np.uint64)
                    for g in range(L):
                        k = e * L + g
                        byte = (words[:, k // 4] >> np.uint64(8 * (k % 4))) \
                            & np.uint64(0xFF)
                        v = add_group(v, byte, g, gb)
                    buf[base + full + e] = (v + salt) & M32
                    writes[base + full + e] += 1
                tail = i[i + VPT > N]
            else:
                tail = i
        else:
            tail = i
        for t in tail:  # byte by byte (and every value of other lengths)
            for j in range(int(t), min(int(t) + VPT, N)):
                v = 0
                for g in range(L):
                    if gb * g < 32:
                        v = add_group(v, int(flat[j * L + g]), g, gb)
                buf[base + j] = (v + salt) & M32
                writes[base + j] += 1
    return buf, writes


def check_mirror(bc, salt):
    """The mirror writes every class value once and nothing else, equal
    to the plain version and the reference's unpack."""
    buf, writes = mirror_launch(bc, salt)
    inside = np.zeros(buf.shape[0], bool)
    for o, (_, b) in zip(bc.offsets, bc.classes):
        inside[int(o) : int(o) + b.shape[0]] = True
    np.testing.assert_array_equal(writes, inside.astype(np.int64))
    plain = bc.plain(salt64(salt))
    for o, (L, b), p in zip(bc.offsets, bc.classes, plain):
        got = buf[int(o) : int(o) + b.shape[0]].astype(np.uint32)
        np.testing.assert_array_equal(got, p.numpy().view(np.uint32))
        if b.shape[0]:
            cols = tuple(jnp.asarray(np.ascontiguousarray(b.numpy()[:, g]))
                         for g in range(L))
            ref = np.asarray(j_ud._byteclass_unpack(cols, bc.group_bits,
                                                    jnp.uint32(salt)))
            np.testing.assert_array_equal(got, ref)
    return buf


# ---------------------------------------------------------------------------
# plans of the five byte codecs
# ---------------------------------------------------------------------------


def byte_lists(codec, seed=41):
    """Gap lists with every byte length; the partial 256-blocks of
    varintg8iu (interpolative) under 2^22."""
    rng = np.random.default_rng(seed)
    lists = []
    for n in (1, 7, 255, 256, 900, 1500):
        v = rng.integers(0, 1 << 10, n).astype(np.uint64)
        v[rng.integers(0, n, max(1, n // 6))] = rng.integers(
            1 << 14, 1 << 27, max(1, n // 6))
        v[rng.integers(0, n, max(1, n // 9))] = rng.integers(
            1 << 28, 1 << 32, max(1, n // 9), dtype=np.uint64)
        v = v.astype(np.uint32)
        if codec == "varintg8iu":
            v[v.shape[0] // 256 * 256 :] &= (1 << 22) - 1
        lists.append(v)
    return lists


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """{codec: (port plan, reference plan, the lists)} from one seed."""
    tmp = tmp_path_factory.mktemp("byteclass")
    out = {}
    for codec in BYTE_CODECS:
        lists = byte_lists(codec)
        payloads = [j_vz.encode_list_zoo(codec, g)[0] for g in lists]
        path = str(tmp / f"s.{codec}")
        j_stream.write_stream(path, payloads, [len(g) for g in lists],
                              [int(g.astype(np.int64).sum()) for g in lists])
        arena, meta = t_stream.load_stream(path)
        out[codec] = (t_ud.plan_byteclass(codec, arena, meta),
                      j_ud.plan_byteclass(codec, arena, meta), lists)
    return out


@pytest.mark.parametrize("codec", BYTE_CODECS)
def test_mirror_on_each_codec_plan(plans, codec):
    """The engine's ByteClasses of each codec's plan: the mirror equals
    the plain version and the reference's unpack for three salts, and
    the classes cover both group widths between them."""
    tplan, _, _ = plans[codec]
    eng = t_ud.ByteClassEngine(tplan, device="cpu")
    bc = eng._x4
    assert bc.group_bits == (7 if codec in ("vbyte", "maskedvbyte") else 8)
    assert len(bc.classes) >= 4
    for s in SALTS:
        check_mirror(bc, s)


def test_mirror_on_edge_classes():
    """``chip_smoke.x4_edge_classes`` (what the card checks): lengths 1-5,
    sizes no multiple of four or of a block, an empty class in the
    middle, both group widths, the three salts; the fifth group keeps 4
    bits (7) or falls off (8)."""
    cases = x4_edge_classes("cpu")
    assert sorted(bc.group_bits for _, bc in cases) == [7, 8]
    for _, bc in cases:
        assert (bc.offsets % 4 == 0).all()
        assert any(b.shape[0] == 0 for _, b in bc.classes)
        for s in SALTS:
            buf = check_mirror(bc, s)
        gb = bc.group_bits
        L5 = next(i for i, (L, b) in enumerate(bc.classes)
                  if L == 5 and b.shape[0])
        b = bc.classes[L5][1].numpy().astype(np.uint64)
        o = int(bc.offsets[L5])
        mask = 0xFF if gb == 8 else 0x7F
        want = np.zeros(b.shape[0], np.uint64)
        for g in range(4):
            want |= (b[:, g] & np.uint64(mask)) << np.uint64(gb * g)
        if gb == 7:
            want |= (b[:, 4] & np.uint64(0xF)) << np.uint64(28)
        want = (want + np.uint64(SALTS[-1])) & np.uint64(M32)
        np.testing.assert_array_equal(buf[o : o + b.shape[0]], want)


def test_table_partition():
    """Each class starts its blocks where the classes before it end; an
    empty class takes none; more than MAX_CLASSES is refused."""
    t = t_ud.byteclass_table([5, 0, VPB + 1, 2 * VPB], [1, 2, 3, 4])
    np.testing.assert_array_equal(t[:, 4], [0, 1, 1, 3])
    np.testing.assert_array_equal(t[:, 2:4], [[5, 1], [0, 2], [VPB + 1, 3],
                                              [2 * VPB, 4]])
    assert t_ud.X4_VALUES_PER_BLOCK == VPB
    assert t_ud.X4_MAX_CLASSES == MAX_CLASSES
    with pytest.raises(ValueError, match="at most"):
        t_ud.byteclass_table([1] * (MAX_CLASSES + 1), [1] * (MAX_CLASSES + 1))


def replay_reference_chain(jplan, runs):
    """The reference's chain body (``ByteClassEngine.timed_chain``,
    unpack_device.py:803-823) run step by step with its own
    ``_byteclass_unpack``: per run each class's first 8 salted values and
    the salted tails summed in u32, minus the salt's share, plus salt +
    1."""
    gb = jplan.group_bits
    classes = [tuple(jnp.asarray(np.ascontiguousarray(b[:, i]))
                     for i in range(int(L)))
               for L, b, _ in jplan.classes if b.shape[0]]
    pvals = np.concatenate([v for _, v in jplan.partials]
                           or [np.zeros(0, np.uint32)]).astype(np.uint64)
    salt = 1
    for _ in range(runs):
        s, cnt = 0, 0
        for cols in classes:
            out = np.asarray(j_ud._byteclass_unpack(cols, gb,
                                                    jnp.uint32(salt)))
            samp = out[:8].astype(np.uint64)
            s += int(samp.sum())
            cnt += samp.size
        s += int(((pvals + salt) & M32).sum())
        cnt += pvals.size
        salt = (s - salt * cnt + salt + 1) & M32
    return salt


@pytest.mark.parametrize("codec", BYTE_CODECS)
def test_engine_decodes_and_chains_like_the_reference(plans, codec):
    """ByteClassEngine through byteclass_unpack on the CPU: every value
    in stream order equal to the lists and to the reference engine's,
    the chain checksum equal to the reference chain's, and no launch
    counted."""
    tplan, jplan, lists = plans[codec]
    t_ud.reset_launch_counts()
    eng = t_ud.ByteClassEngine(tplan, device="cpu")
    got = eng.decode_all_ordered()
    np.testing.assert_array_equal(got, np.concatenate(lists))
    np.testing.assert_array_equal(
        got, j_ud.ByteClassEngine(jplan).decode_all_ordered())
    assert (got >= 1 << 31).any()
    eng.timed_chain(3)
    assert eng.final_checksum == replay_reference_chain(jplan, 3)
    assert t_ud.launch_counts()["X4_byteclass_unpack"] == 0


def test_byteclasses_refuse_what_the_kernel_does_not_take():
    cpu = torch.device("cpu")
    b = torch.zeros((5, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="group_bits"):
        t_ud.ByteClasses([(3, b)], 6, cpu)
    with pytest.raises(ValueError, match="uint8"):
        t_ud.ByteClasses([(3, b.to(torch.int32))], 8, cpu)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        t_ud.ByteClasses([(2, b)], 8, cpu)
    with pytest.raises(ValueError, match="uint8 on cpu"):
        t_ud.ByteClasses([(3, b.to("meta"))], 8, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        t_ud.ByteClasses([(3, torch.zeros((3, 5), dtype=torch.uint8).t())],
                         8, cpu)
    bc = t_ud.ByteClasses([(3, b)], 8, cpu)
    with pytest.raises(ValueError, match="1-element int64"):
        t_ud.byteclass_unpack(bc, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="salt on"):
        t_ud.byteclass_unpack(bc, salt64(1).to("meta"))
    outs = t_ud.byteclass_unpack(bc, salt64(7))
    assert outs is bc.outs and outs[0].dtype == torch.int32
    assert (outs[0] == 7).all()
