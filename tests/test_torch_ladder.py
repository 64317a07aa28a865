"""The ladder leg of the port against the reference.

The port's copies of the native ladder builders, the ladder planners,
the ``UnpackEngine`` (PyTorch ops) and ``decode_stream(engine="ladder")``
must equal ``dint_tpu``'s on the same inputs, made with numpy from a
seed: every ladder width, a partial tail, ``base_relative`` both ways,
words with bit 31 set.  Every comparison is exact (integers).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.index import stream as j_stream
from dint_tpu.io import collection as j_collection
from dint_tpu.io import synth as j_synth
from dint_tpu.kernels import unpack_device as j_ud
from dint_tpu.query import native_host as j_nh
from dint_tpu.tools import decode as j_decode
from dint_tpu.tools import encode as j_encode
from dint_tpu_torch.index import stream as t_stream
from dint_tpu_torch.kernels import unpack_device as t_ud
from dint_tpu_torch.query import native_host as t_nh
from dint_tpu_torch.tools import decode as t_decode

MASK = 0xFFFFFFFF
CLI_TYPES = ("single_packed_dint", "multi_packed_dint")


def gap_stream(seed=17, tail=100):
    """Blocks of every ladder width (values up to 2^32 - 1), all-zero
    blocks, and a partial tail."""
    rng = np.random.default_rng(seed)
    parts = []
    for w in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 19, 31, 32):
        v = rng.integers(0, 1 << w, size=512, dtype=np.uint64)
        v[::5] = (1 << w) - 1  # every field of some word at its maximum
        parts.append(v.astype(np.uint32))
    parts.append(np.zeros(300, np.uint32))
    parts.append(rng.integers(0, 9, size=212 + tail, dtype=np.uint32))
    return np.concatenate(parts)


def mono_stream(seed=18, n=3000):
    rng = np.random.default_rng(seed)
    return np.cumsum(
        rng.integers(1, 5000, size=n, dtype=np.uint64)).astype(np.uint32)


STREAMS = {
    "gaps": (gap_stream(), False),
    "gaps_rel": (gap_stream(seed=3, tail=0), True),
    "mono_rel": (mono_stream(), True),
    "one_block": (gap_stream()[:256], False),
    "tail_only": (gap_stream()[:100], True),
    "empty": (np.zeros(0, np.uint32), False),
}


def reference_plan(flat, rel, native):
    old = os.environ.get("DINT_TPU_NATIVE_LADDER")
    os.environ["DINT_TPU_NATIVE_LADDER"] = "1" if native else "0"
    try:
        return j_ud.ladder_plan_from_values(flat, base_relative=rel)
    finally:
        if old is None:
            del os.environ["DINT_TPU_NATIVE_LADDER"]
        else:
            os.environ["DINT_TPU_NATIVE_LADDER"] = old


def port_plan_of(jplan):
    """The port's plan from the reference plan's numpy fields."""
    return t_ud.plan_from_numpy(
        [dict(b=c.b, payload=c.payload if c.prepacked is None else None,
              prepacked=c.prepacked, out_base=c.out_base, size=c.size,
              val_base=c.val_base) for c in jplan.classes],
        jplan.partials, jplan.total_ints)


def assert_plans_equal(got, want):
    assert (got.codec, got.values_per_block, got.total_ints) == (
        want.codec, want.values_per_block, want.total_ints)
    assert [c.b for c in got.classes] == [c.b for c in want.classes]
    for g, w in zip(got.classes, want.classes):
        np.testing.assert_array_equal(g.out_base, w.out_base)
        np.testing.assert_array_equal(g.size, w.size)
        np.testing.assert_array_equal(g.payload, w.payload)
        for a, b in ((g.prepacked, w.prepacked), (g.val_base, w.val_base)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert len(got.partials) == len(want.partials)
    for (og, vg), (ow, vw) in zip(got.partials, want.partials):
        assert og == ow
        np.testing.assert_array_equal(vg, vw)
    assert got.plan_bytes() == want.plan_bytes()


def reference_checksum(jeng, runs):
    """The final value of the reference's ``timed_chain`` scan
    (unpack_device.py:1180-1199, whose closure returns only the time),
    replayed with the reference engine's own arrays and unpack
    functions."""
    pvals = jnp.asarray(np.concatenate(
        [v for _, v in jeng.plan.partials] or [np.zeros(0, np.uint32)]))
    salt = jnp.uint32(1)
    for _ in range(runs):
        s = jnp.uint32(0)
        cnt = 0
        for kind, b, a0, a1 in jeng._dev:
            out = j_ud._kind_fns(kind, b)[0](a0, a1, salt)
            samp = out[:1, :1, :8]
            s = s + samp.sum(dtype=jnp.uint32)
            cnt += samp.size
        pv = pvals + salt
        s = s + pv.sum(dtype=jnp.uint32)
        cnt += pv.size
        salt = s - salt * jnp.uint32(cnt)
    return int(salt)


# ---------------------------------------------------------------------------
# native builders and planners
# ---------------------------------------------------------------------------


def test_ladder_constants_match_reference():
    assert t_nh.LADDER_WIDTHS == j_nh.LADDER_WIDTHS == t_ud._LADDER
    assert t_ud._LADDER == j_ud._LADDER
    for w in range(0, 40):
        assert t_ud._ladder_width(w) == j_ud._ladder_width(w)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_ladder_from_values_matches_reference(name):
    flat, rel = STREAMS[name]
    got_c, got_t = t_nh.ladder_from_values(flat, 256, rel)
    want_c, want_t = j_nh.ladder_from_values(flat, 256, rel)
    np.testing.assert_array_equal(got_t, want_t)
    assert len(got_c) == len(want_c)
    for g, w in zip(got_c, want_c):
        assert g[0] == w[0] and len(g) == len(w) == 4
        for a, b in zip(g[1:], w[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_ladder_plan_from_values_matches_reference(name, native):
    flat, rel = STREAMS[name]
    got = t_ud.ladder_plan_from_values(flat, base_relative=rel,
                                       native=native)
    assert_plans_equal(got, reference_plan(flat, rel, native))


def test_every_ladder_width_is_exercised():
    plan = t_ud.ladder_plan_from_values(STREAMS["gaps"][0], native=False)
    assert [c.b for c in plan.classes] == list(t_ud._LADDER)
    assert plan.partials and plan.partials[0][1].shape[0] == 100


@pytest.mark.parametrize("w", t_ud._LADDER)
def test_pack_and_lane_major_match_reference(w):
    rng = np.random.default_rng(w)
    hi = (1 << w) - 1
    vals = rng.integers(0, hi + 1, size=(130, 256), dtype=np.uint64)
    vals[:, -1] = hi
    vals = vals.astype(np.uint32)
    got = t_ud._pack_w(vals, w)
    np.testing.assert_array_equal(got, j_ud._pack_w(vals, w))
    np.testing.assert_array_equal(t_ud._lane_major(got),
                                  j_ud._lane_major(got))


def test_plan_from_numpy_carries_the_reference_plan():
    for name in ("gaps", "mono_rel"):
        flat, rel = STREAMS[name]
        for native in (True, False):
            jplan = reference_plan(flat, rel, native)
            assert_plans_equal(port_plan_of(jplan), jplan)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_matches_reference_engine(name, native):
    """One plan through both engines: the same device image, the same
    per-class outputs, the same ordered stream, the same chain
    checksum."""
    flat, rel = STREAMS[name]
    jplan = reference_plan(flat, rel, native)
    jeng = j_ud.UnpackEngine(jplan)
    teng = t_ud.UnpackEngine(port_plan_of(jplan), device="cpu")
    assert teng.device_bytes == jeng.device_bytes
    assert len(teng._dev) == len(jeng._dev)
    for (tk, tw, ta0, ta1), (jk, jw, ja0, ja1) in zip(teng._dev, jeng._dev):
        assert (tk, tw) == (jk, jw)
        np.testing.assert_array_equal(ta0.numpy().view(np.uint32),
                                      np.asarray(ja0))
        assert (ta1 is None) == (ja1 is None)
        if ta1 is not None:
            np.testing.assert_array_equal(ta1.numpy().view(np.uint32),
                                          np.asarray(ja1))
    for t, j in zip(teng.decode_classes(), jeng.decode_classes()):
        np.testing.assert_array_equal(t, j)
    got = teng.decode_all_ordered()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, flat)
    if flat.size:
        np.testing.assert_array_equal(got, jeng.decode_all_ordered())
    for runs in (1, 3):
        assert int(teng.chain(runs).item()) == reference_checksum(jeng, runs)
    assert teng.timed_chain(2) > 0
    assert teng.final_checksum == reference_checksum(jeng, 2)
    assert jeng.timed_chain(2) > 0  # the reference's own chain still runs


@pytest.mark.parametrize("salt", [0, 1, 0x80000000, 0xFFFFFFFF])
@pytest.mark.parametrize("w", [10, 16, 32])
def test_unpack_shifts_are_logical(w, salt):
    """w = 32 with values >= 2^31, and w = 16 / w = 10 with the top
    field's high bit set: int32's arithmetic shift must not leak sign
    bits into a field, and the salt wraps."""
    rng = np.random.default_rng(w)
    hi = (1 << w) - 1
    vals = rng.integers(0, hi + 1, size=(140, 256), dtype=np.uint64)
    vals[:, :: 32 // w] |= 1 << (w - 1)
    vals[0] = hi
    vals = vals.astype(np.uint32)
    words = j_ud._lane_major(j_ud._pack_w(vals, w))
    want = np.asarray(j_ud._fns(w)[0](jnp.asarray(words), None,
                                      jnp.uint32(salt)))
    s32 = torch.tensor(salt - (1 << 32) if salt >= 1 << 31 else salt,
                       dtype=torch.int32)
    got = t_ud._fns(w)(torch.from_numpy(words.view(np.int32)), None, s32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    base = rng.integers(0, 1 << 32, size=140, dtype=np.uint64).astype(
        np.uint32)
    bT = j_ud._lane_major(base[:, None])[0]
    want = np.asarray(j_ud._fns_base(w)[0](jnp.asarray(words),
                                           jnp.asarray(bT),
                                           jnp.uint32(salt)))
    got = t_ud._fns_base(w)(torch.from_numpy(words.view(np.int32)),
                               torch.from_numpy(bT.view(np.int32)), s32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_other_codecs_name_their_roadmap_item():
    """The wire codecs are ported since (qmx and optpfor run on
    UnpackEngine; tests/test_torch_zoo.py holds them to the reference):
    an empty plan of each decodes to nothing, and a codec UnpackEngine
    does not run is refused by name."""
    for codec in ("qmx", "optpfor"):
        eng = t_ud.UnpackEngine(t_ud.UnpackPlan(codec, 256, [], [], 0),
                                device="cpu")
        assert eng.decode_all_ordered().shape == (0,)
    with pytest.raises(ValueError, match="'vbyte' not in"):
        t_ud.UnpackEngine(t_ud.UnpackPlan("vbyte", 256, [], [], 0),
                          device="cpu")


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = t_ud.ladder_plan_from_values(STREAMS["one_block"][0],
                                        native=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ud.UnpackEngine(plan)


# ---------------------------------------------------------------------------
# DINT streams: unit decode, the three image routes, decode_stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_streams(tmp_path_factory):
    """The collection of tests/test_tools_cli.py and both wire formats,
    encoded by the reference: {type: (stream, dict file)}, base."""
    tmp = str(tmp_path_factory.mktemp("torch_ladder"))
    base = os.path.join(tmp, "tc")
    docs, freqs = j_synth.make_collection(120, 9000, seed=77, avg_len=50)
    j_collection.write_freq_collection(base, docs, freqs, 9000)
    out = {}
    old = os.getcwd()
    os.chdir(tmp)
    try:
        for t in CLI_TYPES:
            stream = os.path.join(tmp, f"lad.{t}.bin")
            j_encode.main([t, base + ".docs", "--out", stream])
            kind = "multi_packed" if t.startswith("multi") else \
                "single_packed"
            out[t] = (stream, os.path.join(
                tmp, f"dict.tc.docs.{kind}.DSF-65536-16"))
    finally:
        os.chdir(old)
    return out, base


def _loaded(pkg_stream, pkg_decode, stream, dict_file, type_name):
    arena, meta = pkg_stream.load_stream(stream)
    view = pkg_decode.load_dictionary(type_name, dict_file).decode_view()
    multi = type_name.startswith("multi")
    return arena, meta, view, multi


@pytest.mark.parametrize("type_name", CLI_TYPES)
def test_native_unit_decoders_match_reference(cli_streams, type_name):
    streams, _ = cli_streams
    stream, dict_file = streams[type_name]
    ja, jm, jv, multi = _loaded(j_stream, j_decode, stream, dict_file,
                                type_name)
    ta, tm, tv, _ = _loaded(t_stream, t_decode, stream, dict_file, type_name)
    jl = j_decode.units_from_meta(ja, jm, multi)
    tl = t_decode.units_from_meta(ta, tm, multi)
    jargs = (jv, ja, jl.starts, jl.byte_lens, jl.n, jl.ctx, jl.b_bits)
    targs = (tv, ta, tl.starts, tl.byte_lens, tl.n, tl.ctx, tl.b_bits)
    flat = t_nh.decode_units_flat(*targs)
    np.testing.assert_array_equal(flat, j_nh.decode_units_flat(*jargs))
    got_c, got_t = t_nh.decode_units_to_ladder(*targs)
    want_c, want_t = j_nh.decode_units_to_ladder(*jargs)
    np.testing.assert_array_equal(got_t, want_t)
    assert [c[0] for c in got_c] == [c[0] for c in want_c]
    for g, w in zip(got_c, want_c):
        assert len(g) == len(w) == 3
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    total = int(np.asarray(tm.n, np.int64).sum())
    assert_plans_equal(t_ud.ladder_plan_prepacked(got_c, got_t, total),
                       j_ud.ladder_plan_prepacked(want_c, want_t, total))


def test_malformed_unit_raises(cli_streams):
    streams, _ = cli_streams
    stream, dict_file = streams["single_packed_dint"]
    ta, tm, tv, multi = _loaded(t_stream, t_decode, stream, dict_file,
                                "single_packed_dint")
    tl = t_decode.units_from_meta(ta, tm, multi)
    short = tl.byte_lens.copy()
    big = int(np.argmax(tl.n))
    short[big] = 1
    for fn in (t_nh.decode_units_flat, t_nh.decode_units_to_ladder):
        with pytest.raises(ValueError, match="malformed unit"):
            fn(tv, ta, tl.starts, short, tl.n, tl.ctx, tl.b_bits)


@pytest.mark.parametrize("route", t_decode.LadderStreamDecoder.ROUTES)
@pytest.mark.parametrize("type_name", CLI_TYPES)
def test_ladder_decoder_routes_equal_reference(cli_streams, type_name,
                                               route):
    """Every image route (fused native, native flat, numpy oracle)
    builds an engine whose lists equal the reference decoder's and the
    collection."""
    streams, base = cli_streams
    stream, dict_file = streams[type_name]
    ja, jm, jv, multi = _loaded(j_stream, j_decode, stream, dict_file,
                                type_name)
    jdec = j_decode.LadderStreamDecoder(ja, jm, jv, multi)
    ta, tm, tv, _ = _loaded(t_stream, t_decode, stream, dict_file, type_name)
    tdec = t_decode.LadderStreamDecoder(ta, tm, tv, multi, device="cpu",
                                        route=route)
    assert tdec.plan_bytes == jdec.plan_bytes
    jl, tl = jdec.gather_lists(), tdec.gather_lists()
    assert len(jl) == len(tl) == jm.num_lists
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    elapsed, total = tdec.timed_runs(2)
    assert elapsed > 0 and total == int(np.asarray(tm.n, np.int64).sum())
    assert tdec.final_salt == reference_checksum(jdec.engine, 2)


def test_unknown_route_raises(cli_streams):
    streams, _ = cli_streams
    stream, dict_file = streams["single_packed_dint"]
    ta, tm, tv, multi = _loaded(t_stream, t_decode, stream, dict_file,
                                "single_packed_dint")
    with pytest.raises(ValueError, match="route"):
        t_decode.LadderStreamDecoder(ta, tm, tv, multi, device="cpu",
                                     route="bogus")


@pytest.mark.parametrize("type_name", CLI_TYPES)
def test_decode_stream_ladder_exact(cli_streams, type_name):
    """decode_stream(engine='ladder', device='cpu') reproduces the
    collection int for int and keeps the reference's record."""
    streams, base = cli_streams
    stream, dict_file = streams[type_name]
    jrec = j_decode.decode_stream(type_name, stream, dict_file, runs=2,
                                  check_collection=base + ".docs",
                                  engine="ladder")
    trec = t_decode.decode_stream(type_name, stream, dict_file, runs=2,
                                  check_collection=base + ".docs",
                                  engine="ladder", device="cpu")
    assert trec["check"] == "ok" == jrec["check"]
    assert int(trec["plan_bytes"]) > 0
    assert set(trec) == set(jrec) | {"device"}
    assert "rows" not in trec and "geometry" not in trec
    for k in ("num_sequences", "num_integers", "type", "engine", "runs",
              "plan_bytes"):
        assert trec[k] == jrec[k], k


def test_cli_main_takes_the_ladder_engine(cli_streams, capsys):
    import json

    streams, base = cli_streams
    stream, dict_file = streams["multi_packed_dint"]
    t_decode.main(["multi_packed_dint", stream, "--dict", dict_file,
                   "--runs", "1", "--check-collection", base + ".docs",
                   "--engine", "ladder", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["check"] == "ok" and rec["engine"] == "ladder"
    assert rec["device"] == "cpu"
