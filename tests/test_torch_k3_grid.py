"""K3's grid (``csrc/decode_gather.cu``), alone and inside the fused class
launch, mirrored in numpy on the CPU.

The kernel runs on the card only.  Here its launch shape is read from
the source (``THREADS``, ``LANES_PER_BLOCK``, ``ZERO_VEC``), and a
numpy mirror of ``zero_blocks``, ``class_blocks``, ``zero_rows`` and the
fused launch's block partition lists, for every block and thread, the
16-byte stores it makes and the values it writes.  Each output lane of
the zero class must be written exactly once, nothing past the class (a
last block only partly filled), and the values must equal the plain
version (``zero_plain``, ``decode_classes_plain``), which
``test_torch_decode_local`` holds to the reference's Pallas body.
"""

import os
import re

import numpy as np
import pytest
import torch

from dint_tpu_torch.kernels import decode_local as t_dl

SRC = os.path.join(os.path.dirname(t_dl.__file__), "csrc", "decode_gather.cu")
N_OUTS = [128, 256, 512, 1024]
SALTS = (0, 1, 0xFFFFFFFF)


def constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", open(SRC).read())
    assert m, f"{name} not found in {SRC}"
    return int(m.group(1))


THREADS = constant("THREADS")
LANES_PER_BLOCK = constant("LANES_PER_BLOCK")
ZERO_VEC = constant("ZERO_VEC")


def class_blocks(rows, n_out):
    rpb = LANES_PER_BLOCK // n_out
    return -(-rows // rpb)


def zero_blocks(rows, n_out):
    return -(-(rows * (n_out // 4)) // (THREADS * ZERO_VEC))


def zero_stores(rows, n_out, block):
    """The int4 indices block ``block`` of a zero class of ``rows`` rows
    stores to (relative to the class's first row), each thread's
    ZERO_VEC of them THREADS apart."""
    t = np.arange(THREADS)[None, :]
    k = np.arange(ZERO_VEC)[:, None]
    g = block * THREADS * ZERO_VEC + k * THREADS + t
    return g[g < rows * (n_out // 4)]


def i32(salt):
    """The int32 whose bits are the u32 ``salt``."""
    return salt - (1 << 32) if salt >= 1 << 31 else salt


def zero_values(g, n, fill, n_out, exact=False):
    """The four lanes of each int4 ``g``: the fill where the lane is below
    its row's n, 0 elsewhere; the exact output is 0 and reads no n."""
    if exact:
        return np.zeros((g.size, 4), np.int64)
    per_row = n_out // 4
    nr = n[g // per_row][:, None].astype(np.int64)
    j = (g % per_row)[:, None] * 4 + np.arange(4)[None, :]
    return np.where(j < nr, fill, 0)


def gather_lanes(rows, n_out, block):
    """(row, first lane) of each thread of a gather-body block that owns
    a row (the others return at once)."""
    per_row = n_out // 4
    rpb = LANES_PER_BLOCK // n_out
    t = np.arange(THREADS)
    lr = t // per_row
    r = block * rpb + lr
    keep = (lr < rpb) & (r < rows)
    return r[keep], (t[keep] - lr[keep] * per_row) * 4


def n_for(rows, n_out, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, n_out + 1, rows).astype(np.int32)
    n[: min(rows, 3)] = np.array([0, n_out, 1], np.int32)[: min(rows, 3)]
    return n


def rows_cases(n_out):
    """Row counts: one row, a few, no multiple of a block, exactly three
    blocks, three blocks and a row, and one more than a gather block."""
    per_block = THREADS * ZERO_VEC // (n_out // 4)
    return [1, 5, 67, 3 * per_block, 3 * per_block + 1,
            LANES_PER_BLOCK // n_out + 1]


def test_launch_shape_read_from_the_source():
    assert THREADS == 256 and LANES_PER_BLOCK == 1024
    assert ZERO_VEC >= 1 and (THREADS * ZERO_VEC * 4) % 1024 == 0


@pytest.mark.parametrize("n_out", N_OUTS)
def test_k3_alone_writes_each_lane_once(n_out):
    """The stand-alone K3 grid: every lane of the class written exactly
    once, no store past the class, the values of ``zero_plain`` for the
    three salts and for the exact output."""
    for rows in rows_cases(n_out):
        n = n_for(rows, n_out, rows)
        for salt in SALTS:
            fill = i32(salt)
            writes = np.zeros(rows * n_out // 4, np.int64)
            out = np.full((rows * n_out // 4, 4), -7, np.int64)
            for b in range(zero_blocks(rows, n_out)):
                g = zero_stores(rows, n_out, b)
                assert g.size, (rows, b)  # no block without a store
                assert (g < rows * n_out // 4).all()
                np.add.at(writes, g, 1)
                out[g] = zero_values(g, n, fill, n_out)
                out_exact = zero_values(g, n, fill, n_out, exact=True)
                assert not out_exact.any()
            assert (writes == 1).all(), (n_out, rows)
            want = t_dl.zero_plain(torch.from_numpy(n),
                                   torch.tensor([salt]), n_out).numpy()
            np.testing.assert_array_equal(out.reshape(rows, n_out), want)


@pytest.mark.parametrize("present", ["all", "no_u16", "zero_alone",
                                     "no_zero"])
@pytest.mark.parametrize("n_out", N_OUTS)
def test_fused_partition_writes_each_lane_once(n_out, present):
    """The fused launch's grid (``dint_decode_classes``: u16 blocks, then
    i32, then zero_blocks of the zero class) over classes of row counts
    that are no multiple of a block, some empty: every lane of the
    (R0 + R16 + R32, n_out) buffer written once, by its own class's body;
    the zero rows' values those of ``decode_classes_plain`` in both
    flags."""
    per_block = THREADS * ZERO_VEC // (n_out // 4)
    rows = {"zero": 2 * per_block + 3, "u16": 37, "i32": 5}
    if present == "no_u16":
        rows["u16"] = 0
    elif present == "zero_alone":
        rows["u16"] = rows["i32"] = 0
    elif present == "no_zero":
        rows["zero"] = 0
    r0, r16, r32 = rows["zero"], rows["u16"], rows["i32"]
    n0 = n_for(r0, n_out, 3)
    b16, b32 = class_blocks(r16, n_out), class_blocks(r32, n_out)
    grid = b16 + b32 + zero_blocks(r0, n_out)
    owner = np.full((r0 + r16 + r32, n_out), -1, np.int64)
    writes = np.zeros_like(owner)
    for salt in (0, 0x9E3779B9):
        for exact in (False, True):
            fill = i32(salt)
            zero_out = np.full((r0 * n_out // 4, 4), -7, np.int64)
            for b in range(grid):
                if b < b16 + b32:  # the gather bodies: K2's, then K1's
                    body, base, cls_rows, blk = ((16, r0, r16, b) if b < b16
                                                 else (32, r0 + r16, r32,
                                                       b - b16))
                    r, j = gather_lanes(cls_rows, n_out, blk)
                    lanes = (base + r)[:, None], j[:, None] + np.arange(4)
                else:
                    body = 0
                    g = zero_stores(r0, n_out, b - b16 - b32)
                    zero_out[g] = zero_values(g, n0, fill, n_out, exact)
                    lanes = ((g // (n_out // 4))[:, None],
                             (g % (n_out // 4))[:, None] * 4 + np.arange(4))
                if salt == 0 and not exact:
                    np.add.at(writes, lanes, 1)
                    owner[lanes] = body
            if r0:
                want = t_dl.decode_classes_plain(
                    torch.from_numpy(n0), None, None,
                    torch.tensor([salt]), exact, n_out).numpy()
                np.testing.assert_array_equal(zero_out.reshape(r0, n_out),
                                              want)
    assert (writes == 1).all()
    assert (owner[:r0] == 0).all() and (owner[r0 : r0 + r16] == 16).all()
    assert (owner[r0 + r16 :] == 32).all()
