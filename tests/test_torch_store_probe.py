"""The store probe (K5) against the reference's Pallas probe.

The reference's ``_probe_fns`` has no interpret argument, so it runs here
under ``pltpu.force_tpu_interpret_mode()``.  The port's plain version
(the path a CPU tensor takes) must write the same tile pattern and its
chain must reach the same salt.  Every comparison is exact (integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dint_tpu.kernels import store_probe as j_sp
from dint_tpu_torch.kernels import store_probe as t_sp

MASK = 0xFFFFFFFF


def reference_tile(rows, rt, salt):
    """One write of a copy of the reference's kernel body
    (store_probe.py:37-54; there it is a closure that only the chain
    reaches) through the same pallas_call shape, in interpret mode.  The
    chain tests below tie the copy to the reference itself."""
    def kernel(salt_ref, out_ref):
        i = pl.program_id(0)
        lane = jax.lax.broadcasted_iota(jnp.int32, (rt, j_sp.ROW_LANES), 1)
        row = jax.lax.broadcasted_iota(jnp.int32, (rt, j_sp.ROW_LANES), 0)
        out_ref[...] = lane + row * 7 + salt_ref[0] + i

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            kernel, grid=(rows // rt,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((rt, j_sp.ROW_LANES), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((rows, j_sp.ROW_LANES), jnp.int32),
        )(jnp.asarray([salt], jnp.uint32).view(jnp.int32)))


@pytest.mark.parametrize("salt", [0, 1, 0x7FFFFFF0, 0xFFFFFFFF])
@pytest.mark.parametrize("rows,rt", [(64, 32), (96, 32), (1024, 1024)])
def test_plain_tile_matches_pallas_body(rows, rt, salt):
    got = t_sp.store_tile(t_sp.salt_tensor(salt, "cpu"), rows, rt)
    assert got.dtype == torch.int32 and got.shape == (rows, t_sp.ROW_LANES)
    np.testing.assert_array_equal(got.numpy(), reference_tile(rows, rt, salt))


def test_row_is_the_row_inside_the_tile():
    """out[r] depends on r % row_tile and r // row_tile, not on r."""
    out = t_sp.store_tile_plain(t_sp.salt_tensor(3, "cpu"), 4, 2).numpy()
    want = np.arange(256)[None, :] + 3 + np.array(
        [0 * 7 + 0, 1 * 7 + 0, 0 * 7 + 1, 1 * 7 + 1])[:, None]
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("rows,rt,runs", [(2048, 1024, 3), (256, 128, 5),
                                          (128, 128, 1)])
def test_chain_salt_matches_reference(rows, rt, runs):
    with pltpu.force_tpu_interpret_mode():
        want = int(np.asarray(j_sp._probe_fns(rows, rt)(runs=runs)))
    got = int(t_sp.probe_chain(rows, rt, runs, torch.device("cpu")).item())
    assert got & MASK == want & MASK
    if (rows, rt, runs) == (2048, 1024, 3):
        assert got == 56426500


def test_probe_rows_keeps_the_reference_rounding():
    for total, rt in ((64 << 20, 1024), (16_719_980 * 4, 1024), (10, 1024),
                      (5000 * 1024, 512)):
        R = max(total // (4 * j_sp.ROW_LANES), rt)
        assert t_sp.probe_rows(total, rt) == (R // rt) * rt
    assert t_sp.probe_rows(16_719_980 * 4) == 64_512


def test_probe_runs_on_the_cpu_and_counts_no_launch():
    t_sp.reset_launch_counts()
    gbps = t_sp.probe_store_gbps(1 << 20, runs=2, device="cpu")
    assert gbps > 0
    assert t_sp.launch_counts() == {"K5_store_tile": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    s = t_sp.salt_tensor(1, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        t_sp.store_tile(s, 100, 64)
    with pytest.raises(ValueError, match="int32"):
        t_sp.store_tile(torch.ones(1, dtype=torch.int64), 64, 64)
    with pytest.raises(ValueError, match="out must be"):
        t_sp.store_tile(s, 64, 64, out=torch.empty((64, 128),
                                                   dtype=torch.int32))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sp.probe_store_gbps(1 << 20, runs=1)
