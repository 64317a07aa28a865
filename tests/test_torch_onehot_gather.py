"""The one-hot gather (K6, K7) and the flat gather against the reference.

On the plan of ``tests/test_decode_pallas.py`` (real DINT units, random
wide gaps, a run-heavy list) the port's ``decode_gather_rows`` (the plain
version of K6 and K7), ``gather_flat`` and the CPU path of
``decode_gather_pallas{,_grid}`` must equal the reference's Pallas kernel
(interpret mode) and its XLA one-hot product bit for bit, for every
salt.  Every comparison is exact (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.codecs import dint as j_dint
from dint_tpu.kernels import decode_local as j_dl
from dint_tpu.kernels import decode_pallas as j_dp
from dint_tpu_torch.kernels import decode_local as t_dl
from dint_tpu_torch.kernels import decode_pallas as t_dp
from tests.test_batch_encode_decode import setup  # noqa: F401

SALTS = (0, 7, 0x9E3779B9)


@pytest.fixture(scope="module")
def plan_arrays(setup):  # noqa: F811
    """(vidx i32, table u32, out_n i32) of the reference plan, rows
    padded to ROW_BLOCK, and the reference outputs per salt."""
    gap_lists, ds, _ = setup
    lt = ds.lookup_table()
    view = ds.decode_view()
    rng = np.random.default_rng(33)
    lists = [g for g in gap_lists if 0 < len(g) <= 3000][:12]
    for _ in range(3):
        n = int(rng.integers(40, 800))
        g = rng.integers(0, 1 << 22, n).astype(np.uint32)
        g[rng.random(n) < 0.3] = 0
        lists.append(g)
    lists.append(
        np.where(rng.random(5000) < 0.8, 0, rng.integers(0, 300, 5000))
        .astype(np.uint32)
    )
    bufs = [j_dint.encode_opt_single(lt, g) for g in lists]
    starts = np.cumsum([0] + [len(b) for b in bufs])[:-1]
    arena = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    plan = j_dl.plan_stream(
        arena, starts, [len(b) for b in bufs], [len(g) for g in lists],
        [0] * len(bufs), [16] * len(bufs), view,
    )
    RB = j_dp.ROW_BLOCK
    padR = -(-plan.rows // RB) * RB

    def pad(a):
        z = np.zeros((padR - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, z])

    vidx = pad(j_dl.plan_to_vidx(plan)).astype(np.int32)
    table = pad(plan.table)
    out_n = pad(plan.out_n).astype(np.int32)
    want = {}
    for salt in SALTS:
        xla = np.asarray(j_dl.decode_gather_rows(
            jnp.asarray(vidx), jnp.asarray(table), jnp.asarray(out_n),
            jnp.uint32(salt)))
        pallas = np.asarray(j_dp.decode_gather_pallas(
            jnp.asarray(vidx), jnp.asarray(table.view(np.int32)),
            jnp.asarray(out_n), jnp.uint32(salt), interpret=True,
        )).view(np.uint32)
        np.testing.assert_array_equal(pallas, xla)
        want[salt] = pallas
    return vidx, table, out_n, want


def _args(vidx, table, out_n, salt):
    return (torch.from_numpy(vidx), torch.from_numpy(table.view(np.int32)),
            torch.from_numpy(out_n), torch.tensor([salt], dtype=torch.int64))


def _u32(t):
    return t.numpy().view(np.uint32)


def test_module_constants_match_reference():
    assert (t_dp.ROW_BLOCK, t_dp.G) == (j_dp.ROW_BLOCK, j_dp.G)


@pytest.mark.parametrize("salt", SALTS)
def test_decode_gather_rows_matches_pallas(plan_arrays, salt):
    vidx, table, out_n, want = plan_arrays
    got = t_dl.decode_gather_rows(*_args(vidx, table, out_n, salt))
    assert got.dtype == torch.int32 and got.shape == vidx.shape
    np.testing.assert_array_equal(_u32(got), want[salt])


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("fn", ["decode_gather_pallas",
                                "decode_gather_pallas_grid"])
def test_wrapper_cpu_path_matches_pallas(plan_arrays, fn, salt):
    vidx, table, out_n, want = plan_arrays
    t_dp.reset_launch_counts()
    got = getattr(t_dp, fn)(*_args(vidx, table, out_n, salt))
    np.testing.assert_array_equal(_u32(got), want[salt])
    assert set(t_dp.launch_counts().values()) == {0}


@pytest.mark.parametrize("salt", SALTS)
def test_grid_reference_agrees(plan_arrays, salt):
    """The reference's own grid kernel (K7's original) gives the block
    kernel's output, so one plain version stands for both."""
    vidx, table, out_n, want = plan_arrays
    got = np.asarray(j_dp.decode_gather_pallas_grid(
        jnp.asarray(vidx), jnp.asarray(table.view(np.int32)),
        jnp.asarray(out_n), jnp.uint32(salt), interpret=True,
    )).view(np.uint32)
    np.testing.assert_array_equal(got, want[salt])


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int32])
def test_gather_flat_matches_reference(plan_arrays, dtype, salt):
    vidx, table, out_n, want = plan_arrays
    v = vidx.astype(np.uint8).view(dtype) if dtype != np.int32 else vidx
    xla = np.asarray(j_dl._decode_flat_xla(
        jnp.asarray(vidx.astype(np.uint8).view(np.int8)), jnp.asarray(table),
        jnp.asarray(out_n[:, None]), jnp.uint32(salt)))
    got = t_dl.gather_flat(torch.from_numpy(v),
                           torch.from_numpy(table.view(np.int32)),
                           torch.from_numpy(out_n),
                           torch.tensor([salt], dtype=torch.int64))
    np.testing.assert_array_equal(_u32(got), xla)
    np.testing.assert_array_equal(_u32(got), want[salt])


@pytest.mark.parametrize("salt", (0, 1, 0xFFFFFFFF))
def test_random_tables_and_out_of_range_indices(salt):
    """Full-range table words (bit 31 set: the byte planes need logical
    shifts), n = 0 and n = N_OUT rows, and indices outside [0, 256),
    which select nothing and give 0x80808080 - salt in the reference."""
    rng = np.random.default_rng(5)
    R = j_dp.ROW_BLOCK
    vidx = rng.integers(0, 256, (R, 256)).astype(np.int32)
    vidx[3, 5], vidx[4, 7], vidx[9, 0] = 300, -1, 256
    table = rng.integers(0, 1 << 32, (R, 256), dtype=np.uint64).astype(
        np.uint32)
    table[:, ::7] |= 0x80000000
    n = rng.integers(0, 257, R).astype(np.int32)
    n[:10] = 256
    n[10], n[11] = 0, 1
    want = np.asarray(j_dp.decode_gather_pallas(
        jnp.asarray(vidx), jnp.asarray(table.view(np.int32)), jnp.asarray(n),
        jnp.uint32(salt), interpret=True)).view(np.uint32)
    got = _u32(t_dl.decode_gather_rows(*_args(vidx, table, n, salt)))
    np.testing.assert_array_equal(got, want)
    assert got[3, 5] == (0x80808080 - salt) & 0xFFFFFFFF


def test_engine_total_ints_and_tensor_salt(plan_arrays, setup):  # noqa: F811
    """LocalDecodeEngine.total_ints, and decode_all with a tensor salt
    (the ablation's chain) equal to the int salt's output."""
    vidx, table, out_n, _ = plan_arrays
    R = int(np.flatnonzero(out_n).max()) + 1
    # a synthetic plan: local id 0 is one entry covering the whole row
    # (length n at table offset 0), every other token names the empty
    # local id 1, so the row decodes to table[r, 0:n]
    tokens = np.ones((R, t_dl.W_TOKENS), np.int32)
    tokens[:, 0] = 0
    meta = np.zeros((R, t_dl.W_TOKENS), np.int32)
    meta[:, 0] = out_n[:R].astype(np.int32) << 13
    plan = t_dl.LocalPlan(tokens, meta, table[:R].copy(), out_n[:R].copy(),
                          np.arange(R, dtype=np.int64),
                          np.zeros(R, np.int64))
    eng = t_dl.LocalDecodeEngine(plan, device="cpu")
    assert eng.total_ints() == int(out_n.astype(np.int64).sum())
    a = eng.decode_all(0x1234567)
    b = eng.decode_all(torch.tensor([0x1234567], dtype=torch.int64))
    c = eng.decode_all(0)
    assert torch.equal(a, b) and torch.equal(a, c)
    got = np.concatenate(eng.gather_units(a, R, out_n[:R]))
    valid = np.arange(256)[None, :] < out_n[:R, None]
    np.testing.assert_array_equal(got, table[:R][valid])


@pytest.mark.parametrize("fn,rows", [("decode_gather_pallas", 8),
                                     ("decode_gather_pallas_grid", 12)])
def test_row_count_is_checked_as_in_the_reference(fn, rows):
    z = torch.zeros((rows, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        getattr(t_dp, fn)(z, z, torch.zeros(rows, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int64))
