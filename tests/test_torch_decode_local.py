"""The port's decode engine and class kernels against the reference.

The plain PyTorch twins of K1-K3 (the path a CPU tensor takes) must
equal the reference's Pallas class kernels, run through
``_pallas_split_fns`` in interpret mode, on the same inputs; the
engine's outputs and its chain's final salt must equal the reference
engine's bit for bit.  Every comparison is exact.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.index import stream as j_stream
from dint_tpu.kernels import decode_local as j_dl
from dint_tpu.tools import decode as j_decode
from dint_tpu_torch.kernels import decode_local as t_dl
from tests.test_torch_host_copies import encode_both, write_mixed_collection

N_OUT = t_dl.N_OUT
ROWS = 64
RT = 32
SALTS = (0, 1, 0xFFFFFFFF, 0x9E3779B9)
MASK = 0xFFFFFFFF


def edge_inputs(seed=0):
    """One batch of rows per class with the edge cases forced: n = 0 and
    n = N_OUT rows, indices with bit 7 set, table words >= 2^31, and u16
    tables with both halves of a word set."""
    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, 256, (ROWS, N_OUT)).astype(np.uint8)
    vidx[1, :] = 255
    vidx[2, :] = np.arange(N_OUT) % 256 | 0x80
    n = rng.integers(0, N_OUT + 1, ROWS).astype(np.int32)
    n[0], n[1], n[2], n[3] = 0, N_OUT, N_OUT, 1
    tab32 = rng.integers(0, 1 << 32, (ROWS, 256), dtype=np.uint64)
    tab32[:, ::7] |= 0x80000000
    tab32 = tab32.astype(np.uint32)
    tab16 = rng.integers(0, 1 << 32, (ROWS, 128), dtype=np.uint64)
    tab16[:, ::3] |= 0x80008000
    tab16 = tab16.astype(np.uint32)
    return vidx, tab16, tab32, n


@pytest.fixture(scope="module")
def reference_outputs():
    """{salt: (out0, out16, out32)} exact per-class outputs of the
    reference's split decode (Pallas interpret mode)."""
    vidx, tab16, tab32, n = edge_inputs()
    spec = ((ROWS, 0), (ROWS, 16), (ROWS, 32))
    decode, _ = j_dl._pallas_split_fns(spec, RT, True)
    n2 = jnp.asarray(n[:, None])
    args = (
        (jnp.zeros((0,), jnp.int8), jnp.zeros((0,), jnp.int32), n2),
        (jnp.asarray(vidx.view(np.int8)), jnp.asarray(tab16.view(np.int32)),
         n2),
        (jnp.asarray(vidx.view(np.int8)), jnp.asarray(tab32.view(np.int32)),
         n2),
    )
    return {
        s: tuple(np.asarray(o) for o in decode(args, jnp.uint32(s)))
        for s in SALTS
    }


def _salt(s):
    return torch.tensor([s], dtype=torch.int64)


def _u32(t):
    return t.numpy().view(np.uint32)


def _raw_from_exact(exact, n, s):
    """The salted classes' raw contract: exact + salt on valid lanes."""
    valid = np.arange(N_OUT)[None, :] < n[:, None]
    return np.where(valid, (exact.astype(np.uint64) + s) & MASK,
                    0).astype(np.uint32)


@pytest.mark.parametrize("salt", SALTS)
def test_k1_gather32_twin_matches_pallas(reference_outputs, salt):
    vidx, _, tab32, n = edge_inputs()
    got = t_dl.gather32(torch.from_numpy(vidx),
                        torch.from_numpy(tab32.view(np.int32)),
                        torch.from_numpy(n), _salt(salt))
    assert got.dtype == torch.int32 and got.shape == (ROWS, N_OUT)
    np.testing.assert_array_equal(_u32(got), reference_outputs[salt][2])


@pytest.mark.parametrize("salt", SALTS)
def test_k2_gather16_twin_matches_pallas(reference_outputs, salt):
    vidx, tab16, _, n = edge_inputs()
    got = t_dl.gather16(torch.from_numpy(vidx),
                        torch.from_numpy(tab16.view(np.int32)),
                        torch.from_numpy(n), _salt(salt))
    want = _raw_from_exact(reference_outputs[salt][1], n, salt)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("salt", SALTS)
def test_k3_zero_twin_matches_pallas(reference_outputs, salt):
    _, _, _, n = edge_inputs()
    got = t_dl.zero(torch.from_numpy(n), _salt(salt))
    want = _raw_from_exact(reference_outputs[salt][0], n, salt)
    np.testing.assert_array_equal(_u32(got), want)
    assert not reference_outputs[salt][0].any()


def test_k2_reads_both_halves_logically():
    """Words with bit 31 set: the high half must come out unsigned."""
    vidx = torch.tensor([[1, 0] * (N_OUT // 2)], dtype=torch.uint8)
    tab = torch.full((1, 128), 0xFFFE8001 - (1 << 32), dtype=torch.int32)
    got = t_dl.gather16_plain(vidx, tab, torch.tensor([N_OUT], dtype=torch.int32),
                              _salt(0))
    assert got[0, :2].tolist() == [0xFFFE, 0x8001]


def test_wrappers_check_their_inputs():
    vidx, tab16, tab32, n = edge_inputs()
    v, t16, t32, nn = (torch.from_numpy(vidx),
                       torch.from_numpy(tab16.view(np.int32)),
                       torch.from_numpy(tab32.view(np.int32)),
                       torch.from_numpy(n))
    with pytest.raises(ValueError):
        t_dl.gather32(v.to(torch.int32), t32, nn, _salt(0))
    with pytest.raises(ValueError):
        t_dl.gather32(v, t16, nn, _salt(0))  # the u16 table is too narrow
    with pytest.raises(ValueError):
        t_dl.gather16(v, t16, nn.to(torch.int64), _salt(0))
    with pytest.raises(ValueError):
        t_dl.zero(nn, torch.tensor([1], dtype=torch.int32))
    out = torch.empty((ROWS, N_OUT), dtype=torch.int32)
    assert t_dl.gather16(v, t16, nn, _salt(5), out=out) is out
    # the CPU path is the twin: no kernel launch is counted
    t_dl.reset_launch_counts()
    t_dl.gather32(v, t32, nn, _salt(0))
    t_dl.zero(nn, _salt(0))
    assert t_dl.launch_counts() == {
        "K1_gather32": 0, "K2_gather16": 0, "K3_zero": 0}


# ---------------------------------------------------------------------------
# The engine on a real image (all three classes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """{type: (reference DecodeImage, unit ns)} for the mixed collection."""
    root = str(tmp_path_factory.mktemp("torch_engine"))
    base = os.path.join(root, "mixed")
    write_mixed_collection(base)
    out = {}
    for t in ("single_rect_dint", "multi_packed_dint"):
        stream, dict_file = encode_both(os.path.join(root, t), base, t)["jax"]
        arena, meta = j_stream.load_stream(stream)
        lay = j_decode.units_from_meta(arena, meta, t.startswith("multi"))
        view = j_decode.load_dictionary(t, dict_file).decode_view()
        img = j_dl.plan_stream_image(arena, lay.starts, lay.byte_lens, lay.n,
                                     lay.ctx, lay.b_bits, view)
        out[t] = (img, lay.n)
    return out


def _port_image(jimg):
    return t_dl.image_from_numpy(dataclasses.asdict(jimg))


@pytest.mark.parametrize("type_name", ["single_rect_dint",
                                       "multi_packed_dint"])
def test_engine_decode_all_matches_reference(images, type_name):
    jimg, ns = images[type_name]
    assert min(jimg.n0.shape[0], jimg.n16.shape[0], jimg.n32.shape[0]) > 0
    jeng = j_dl.ImageDecodeEngine(jimg)
    teng = t_dl.ImageDecodeEngine(_port_image(jimg), device="cpu")
    assert teng.row_tile == jeng.row_tile
    jout = np.asarray(jeng.decode_all())
    tout = teng.decode_all()
    assert tout.shape == jout.shape and tout.dtype == torch.int32
    np.testing.assert_array_equal(_u32(tout), jout)
    ju = jeng.gather_units(jout, len(ns), ns)
    tu = teng.gather_units(tout, len(ns), ns)
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(a, b)
    assert teng.total_ints() == jeng.total_ints()


@pytest.mark.parametrize("salt", [1, 0xFFFFFFFF])
def test_engine_salted_decode_matches_reference(images, salt):
    jimg, _ = images["single_rect_dint"]
    jeng = j_dl.ImageDecodeEngine(jimg)
    decode, _ = j_dl._pallas_split_fns(jeng._spec, jeng.row_tile, True)
    jouts = decode(jeng._dev, jnp.uint32(salt))
    teng = t_dl.ImageDecodeEngine(_port_image(jimg), device="cpu")
    np.testing.assert_array_equal(
        _u32(teng.decode(salt)), np.concatenate([np.asarray(o) for o in jouts]))


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
def test_decode_chain_salt_matches_reference(images, monkeypatch, sliced):
    jimg, _ = images["single_rect_dint"]
    if sliced:
        monkeypatch.setattr(j_dl, "CHAIN_SUMS_MIN_OUT_BYTES", 0)
        monkeypatch.setattr(t_dl, "CHAIN_SUMS_MIN_OUT_BYTES", 0)
    j_dl._pallas_split_fns.cache_clear()
    try:
        jeng = j_dl.ImageDecodeEngine(jimg)
        teng = t_dl.ImageDecodeEngine(_port_image(jimg), device="cpu")
        for runs in (1, 3):
            want = int(np.asarray(jeng.decode_chain(runs)))
            got = teng.decode_chain(runs)
            assert got.dtype == torch.int64 and got.dim() == 0
            assert int(got) == want, (runs, int(got), want)
    finally:
        j_dl._pallas_split_fns.cache_clear()


def test_image_saved_by_reference_loads_and_decodes(images, tmp_path):
    jimg, ns = images["multi_packed_dint"]
    path = str(tmp_path / "img.image.v3.npz")
    j_dl.save_image(jimg, path)
    timg = t_dl.load_image(path)
    assert timg is not None
    for f in dataclasses.fields(jimg):
        np.testing.assert_array_equal(getattr(timg, f.name),
                                      getattr(jimg, f.name))
    # and the port's file loads in the reference
    t_dl.save_image(timg, str(tmp_path / "port.npz"))
    back = j_dl.load_image(str(tmp_path / "port.npz"))
    assert back is not None and back.total_ints() == jimg.total_ints()
    teng = t_dl.ImageDecodeEngine(timg, device="cpu")
    jeng = j_dl.ImageDecodeEngine(jimg)
    np.testing.assert_array_equal(_u32(teng.decode_all()),
                                  np.asarray(jeng.decode_all()))
    assert t_dl.load_image(str(tmp_path / "absent.npz")) is None


def test_image_from_numpy_requires_every_field(images):
    jimg, _ = images["single_rect_dint"]
    fields = dataclasses.asdict(jimg)
    timg = t_dl.image_from_numpy(fields)
    assert timg.device_bytes() == jimg.device_bytes()
    del fields["seg_pos"]
    with pytest.raises(KeyError):
        t_dl.image_from_numpy(fields)


def test_engine_default_device_raises_without_cuda(images, monkeypatch):
    jimg, _ = images["single_rect_dint"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_dl.ImageDecodeEngine(_port_image(jimg))
