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
    t_dl.decode_classes(nn, (v, t16, nn), (v, t32, nn), _salt(0))
    assert t_dl.launch_counts() == {
        "K1_gather32": 0, "K2_gather16": 0, "K3_zero": 0,
        "K123_decode_classes": 0}
    assert set(t_dl.fused_body_counts().values()) == {0}


# ---------------------------------------------------------------------------
# The fused class launch (its plain version: the path a CPU tensor takes)
# ---------------------------------------------------------------------------


def _edge_classes():
    vidx, tab16, tab32, n = edge_inputs()
    v, nn = torch.from_numpy(vidx), torch.from_numpy(n)
    return (nn, (v, torch.from_numpy(tab16.view(np.int32)), nn),
            (v, torch.from_numpy(tab32.view(np.int32)), nn), n)


@pytest.mark.parametrize("salt", SALTS)
def test_fused_raw_matches_pallas_split(reference_outputs, salt):
    """Raw flag: the three class outputs of the reference's split path in
    engine order (zero, u16, i32), K2's and K3's salt left on."""
    n0, c16, c32, n = _edge_classes()
    got = t_dl.decode_classes(n0, c16, c32, _salt(salt))
    assert got.dtype == torch.int32 and got.shape == (3 * ROWS, N_OUT)
    o0, o16, o32 = reference_outputs[salt]
    want = np.concatenate([_raw_from_exact(o0, n, salt),
                           _raw_from_exact(o16, n, salt), o32])
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("salt", SALTS)
def test_fused_exact_matches_pallas_split(reference_outputs, salt):
    """Exact flag: the reference's decode (the salt removed, 0 past n)."""
    n0, c16, c32, _ = _edge_classes()
    got = t_dl.decode_classes(n0, c16, c32, _salt(salt), exact=True)
    np.testing.assert_array_equal(
        _u32(got), np.concatenate(reference_outputs[salt]))


@pytest.mark.parametrize("exact", [False, True], ids=["raw", "exact"])
@pytest.mark.parametrize("present", [(0,), (16,), (32,), (0, 16), (0, 32),
                                     (16, 32)],
                         ids=lambda p: "classes_" + "_".join(map(str, p)))
def test_fused_with_empty_classes(reference_outputs, present, exact):
    """A class may be None or have no rows: the others keep their order.
    The u16 and i32 classes get row counts that are no multiple of a
    kernel block's rows (61 and 59)."""
    salt = 0x9E3779B9
    n0, c16, c32, n = _edge_classes()
    c16 = tuple(t[:61] for t in c16)
    c32 = tuple(t[:59] for t in c32)
    o0, o16, o32 = reference_outputs[salt]
    want = {0: o0 if exact else _raw_from_exact(o0, n, salt),
            16: (o16 if exact else _raw_from_exact(o16, n, salt))[:61],
            32: o32[:59]}
    empty16 = tuple(t[:0] for t in c16)
    got = t_dl.decode_classes(
        n0 if 0 in present else None,
        c16 if 16 in present else empty16,
        c32 if 32 in present else None, _salt(salt), exact=exact)
    np.testing.assert_array_equal(
        _u32(got), np.concatenate([want[m] for m in present]))


def test_fused_checks_its_inputs():
    n0, c16, c32, _ = _edge_classes()
    with pytest.raises(ValueError):  # the classes swapped: table widths
        t_dl.decode_classes(n0, c32, c16, _salt(0))
    with pytest.raises(ValueError):
        t_dl.decode_classes(n0.to(torch.int64), c16, c32, _salt(0))
    with pytest.raises(ValueError):
        t_dl.decode_classes(n0, c16, c32, torch.tensor([1, 2]))
    with pytest.raises(ValueError):
        t_dl.decode_classes(n0, c16, c32, _salt(0),
                            out=torch.empty((ROWS, N_OUT), dtype=torch.int32))
    out = torch.empty((3 * ROWS, N_OUT), dtype=torch.int32)
    assert t_dl.decode_classes(n0, c16, c32, _salt(3), out=out) is out
    none = t_dl.decode_classes(None, None, None, _salt(3))
    assert none.shape == (0, N_OUT)


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


def _decode_by_passes(eng, salt):
    """``_ClassEngine.decode`` as it was before the fused launch: one
    stand-alone class kernel a class, then int64 passes that take the
    salt of the u16 and zero classes off again."""
    given = isinstance(salt, torch.Tensor)
    s = salt if given else eng._salt(salt)
    buf = torch.empty((eng.rows, N_OUT), dtype=torch.int32)
    for c in eng._classes:
        if not c.rows:
            continue
        o = buf[c.base : c.base + c.rows]
        if c.mode == 0:
            t_dl.zero(c.n, s, N_OUT, out=o)
        elif c.mode == 16:
            t_dl.gather16(*eng.padded(16), s, out=o)
        else:
            t_dl.gather32(*eng.padded(32), s, out=o)
        if c.mode != 32:
            u = (o.to(torch.int64) - s) & MASK
            o.copy_(t_dl._to_i32(torch.where(t_dl._valid(c.n, N_OUT), u, 0)))
    return buf


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
@pytest.mark.parametrize("salt", [0, 1, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                                  0xFFFFFFFF])
def test_engine_decode_is_exact_without_passes(images, salt, as_tensor):
    """decode (one exact fused launch) equals the stand-alone kernels
    followed by the salt-removing passes, for int and tensor salts, the
    sign bit included, and does not depend on the salt."""
    jimg, _ = images["multi_packed_dint"]
    eng = t_dl.ImageDecodeEngine(_port_image(jimg), device="cpu")
    s = _salt(salt) if as_tensor else salt
    got = eng.decode(s)
    assert torch.equal(got, _decode_by_passes(eng, s))
    assert torch.equal(got, eng.decode(0))
    assert torch.equal(eng._run(_salt(0)), got)  # raw at salt 0 is exact


def _subset_image(jimg, keep):
    """``jimg`` with only the width classes of ``keep`` (their segments
    too): an image with empty classes."""
    f = dataclasses.asdict(jimg)
    for mode, names in ((0, ("n0",)), (16, ("vidx16", "tab16", "n16")),
                        (32, ("vidx32", "tab32", "n32"))):
        if mode not in keep:
            for k in names:
                f[k] = f[k][:0]
    seg = np.isin(f["seg_cls"], list(keep))
    for k in list(f):
        if k.startswith("seg_"):
            f[k] = f[k][seg]
    return type(jimg)(**f)


@pytest.mark.parametrize("keep", [(16,), (32,), (0,), (0, 32), (16, 32)],
                         ids=lambda k: "classes_" + "_".join(map(str, k)))
def test_engine_with_empty_classes_matches_reference(images, keep):
    """A one-class image and images with one class empty: outputs and
    both chain salts equal the reference engine's."""
    jimg, _ = images["single_rect_dint"]
    sub = _subset_image(jimg, keep)
    jeng = j_dl.ImageDecodeEngine(sub)
    teng = t_dl.ImageDecodeEngine(_port_image(sub), device="cpu")
    assert teng.rows == sum(c.rows for c in teng._classes) > 0
    assert [c.rows > 0 for c in teng._classes] == [m in keep
                                                   for m in (0, 16, 32)]
    np.testing.assert_array_equal(_u32(teng.decode_all(0x80000001)),
                                  np.asarray(jeng.decode_all()))
    assert int(teng.decode_chain(3)) == int(np.asarray(jeng.decode_chain(3)))


# ---------------------------------------------------------------------------
# LocalPlan: the Python walk, packing, plan files and LocalDecodeEngine
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("tokens", "meta", "table", "out_n", "unit_id", "out_pos",
               "seg_row", "seg_unit", "seg_pos", "seg_off", "seg_len")


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{type: (planner arguments with the reference's view, the same with
    the port's view, unit ns, unit gaps)} of the mixed collection."""
    from dint_tpu_torch.tools import decode as t_decode

    root = str(tmp_path_factory.mktemp("torch_local_plans"))
    base = os.path.join(root, "mixed")
    write_mixed_collection(base)
    out = {}
    for t in ("single_rect_dint", "multi_packed_dint"):
        stream, dict_file = encode_both(os.path.join(root, t), base, t)["jax"]
        arena, meta = j_stream.load_stream(stream)
        lay = j_decode.units_from_meta(arena, meta, t.startswith("multi"))
        geo = (arena, lay.starts, lay.byte_lens, lay.n, lay.ctx, lay.b_bits)
        jview = j_decode.load_dictionary(
            t, dict_file).decode_view()
        tview = t_decode.load_dictionary(t, dict_file).decode_view()
        jplan = j_dl.plan_stream(*geo, jview, prefer_native=False)
        eng = j_dl.LocalDecodeEngine(jplan)
        units = eng.gather_units(eng.decode_all(), len(lay.n), lay.n)
        out[t] = (geo + (jview,), geo + (tview,), lay.n, units)
    return out


def assert_plans_equal(a, b):
    assert a.packed == b.packed and a.rows == b.rows
    assert a.plan_bytes() == b.plan_bytes()
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("type_name", ["single_rect_dint",
                                       "multi_packed_dint"])
def test_plan_stream_py_matches_reference_and_native(layouts, type_name):
    jargs, targs, _, _ = layouts[type_name]
    tpy = t_dl._plan_stream_py(*targs)
    assert_plans_equal(tpy, j_dl._plan_stream_py(*jargs))
    assert_plans_equal(tpy, t_dl.plan_stream(*targs))
    assert not tpy.packed


@pytest.mark.parametrize("type_name", ["single_rect_dint",
                                       "multi_packed_dint"])
def test_pack_plan_units_matches_reference(layouts, type_name):
    jargs, targs, _, _ = layouts[type_name]
    tp = t_dl.plan_stream(*targs, pack_units=True)
    jp = j_dl.plan_stream(*jargs, pack_units=True)
    assert tp.packed and tp.rows < t_dl.plan_stream(*targs).rows
    assert_plans_equal(tp, jp)
    assert_plans_equal(
        tp, t_dl.plan_stream(*targs, prefer_native=False, pack_units=True))


@pytest.mark.parametrize("packed", [False, True], ids=["per_unit", "packed"])
def test_plan_files_cross_load(layouts, tmp_path, packed):
    jargs, targs, _, _ = layouts["multi_packed_dint"]
    tp = t_dl.plan_stream(*targs, pack_units=packed)
    jp = j_dl.plan_stream(*jargs, pack_units=packed)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_dl.save_plan(tp, tpath)
    j_dl.save_plan(jp, jpath)
    assert_plans_equal(j_dl.load_plan(tpath), jp)
    assert_plans_equal(t_dl.load_plan(jpath), tp)
    z = dict(np.load(tpath))
    z["version"] = z["version"] + 1
    np.savez(tpath, **z)
    assert t_dl.load_plan(tpath) is None
    assert t_dl.load_plan(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("packed", [False, True], ids=["per_unit", "packed"])
@pytest.mark.parametrize("type_name", ["single_rect_dint",
                                       "multi_packed_dint"])
def test_local_engine_decode_all_matches_reference(layouts, monkeypatch,
                                                   type_name, packed):
    """Both engines lay rows out class-major (the reference's split path,
    in interpret mode) and give back every unit."""
    jargs, targs, ns, units = layouts[type_name]
    monkeypatch.setattr(j_dl, "FORCE_SPLIT_INTERPRET", True)
    jp = j_dl.plan_stream(*jargs, pack_units=packed)
    jeng = j_dl.LocalDecodeEngine(jp)
    teng = t_dl.LocalDecodeEngine(t_dl.plan_stream(*targs, pack_units=packed),
                                  device="cpu")
    jout = np.asarray(jeng.decode_all())
    tout = teng.decode_all()
    np.testing.assert_array_equal(_u32(tout), jout)
    got = teng.gather_units(tout, len(ns), ns)
    for a, b, c in zip(got, jeng.gather_units(jout, len(ns), ns), units):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    if packed:
        with pytest.raises(AssertionError, match="per-unit rows"):
            teng.row_carry()


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("packed", [False, True], ids=["per_unit", "packed"])
def test_local_decode_chain_matches_reference(layouts, monkeypatch, packed,
                                              sliced):
    """The chained, salted decode of a LocalPlan: the final salt equals
    the reference engine's, with the whole-output sum (the reference's
    portable chain) and with the slice sum of large plans (its split
    chain, interpret mode)."""
    jargs, targs, _, _ = layouts["multi_packed_dint"]
    if sliced:
        monkeypatch.setattr(j_dl, "FORCE_SPLIT_INTERPRET", True)
        monkeypatch.setattr(j_dl, "CHAIN_SUMS_MIN_OUT_BYTES", 0)
        monkeypatch.setattr(t_dl, "CHAIN_SUMS_MIN_OUT_BYTES", 0)
    j_dl._pallas_split_fns.cache_clear()
    try:
        jeng = j_dl.LocalDecodeEngine(
            j_dl.plan_stream(*jargs, pack_units=packed))
        teng = t_dl.LocalDecodeEngine(
            t_dl.plan_stream(*targs, pack_units=packed), device="cpu")
        for runs in (1, 3):
            want = int(np.asarray(jeng.decode_chain(runs)))
            got = teng.decode_chain(runs)
            assert got.dtype == torch.int64 and got.dim() == 0
            assert int(got) == want, (runs, int(got), want)
    finally:
        j_dl._pallas_split_fns.cache_clear()


def test_single_class_chain_matches_reference():
    """The single-class chain (every row through K1) against the
    reference's ``_pallas_decode_fns`` chain in interpret mode."""
    vidx, _, tab32, n = edge_inputs(3)
    _, chain = j_dl._pallas_decode_fns(ROWS, RT, True)
    args = (torch.from_numpy(vidx), torch.from_numpy(tab32.view(np.int32)),
            torch.from_numpy(n))
    for runs in (1, 4):
        want = int(np.asarray(chain(jnp.asarray(vidx.view(np.int8)),
                                    jnp.asarray(tab32.view(np.int32)),
                                    jnp.asarray(n[:, None]), runs=runs)))
        got = t_dl.single_class_chain(*args, runs)
        assert got.dim() == 0 and int(got) == want, runs
