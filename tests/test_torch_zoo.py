"""The vroom zoo in the port against the reference.

The host copies (``codecs/{blocks, qmx, zoonative, ef}``,
``utils/{bitio, bitnative}``, ``index/vroom_zoo``, ``tools.encode``'s
``encode_zoo``) must give the reference package's bytes and values; the
device engines of ``kernels/unpack_device.py`` (the ladder image for
every type, the wire-format engines for optpfor, qmx, simple16 and the
five byte codecs), run as PyTorch ops on the CPU, must decode what the
reference engines decode, plan for plan, with chain checksums that a
numpy replay reproduces; and ``tools.decode``'s zoo paths must check
ok.  Inputs are made with numpy from a seed; every comparison is exact.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dint_tpu.codecs import blocks as j_blocks
from dint_tpu.codecs import ef as j_ef
from dint_tpu.codecs import qmx as j_qmx
from dint_tpu.codecs import zoonative as j_zn
from dint_tpu.codecs.encode_batch import OPT_CHUNK
from dint_tpu.index import stream as j_stream
from dint_tpu.index import vroom_zoo as j_vz
from dint_tpu.io import collection as j_collection
from dint_tpu.io import synth as j_synth
from dint_tpu.kernels import unpack_device as j_ud
from dint_tpu.tools import common as j_common
from dint_tpu.tools import decode as j_decode
from dint_tpu.tools import encode as j_encode
from dint_tpu.utils import bitio as j_bitio
from dint_tpu_torch.codecs import blocks as t_blocks
from dint_tpu_torch.codecs import ef as t_ef
from dint_tpu_torch.codecs import qmx as t_qmx
from dint_tpu_torch.codecs import zoonative as t_zn
from dint_tpu_torch.index import stream as t_stream
from dint_tpu_torch.index import vroom_zoo as t_vz
from dint_tpu_torch.kernels import unpack_device as t_ud
from dint_tpu_torch.tools import common as t_common
from dint_tpu_torch.tools import decode as t_decode
from dint_tpu_torch.tools import encode as t_encode
from dint_tpu_torch.utils import bitio as t_bitio
from dint_tpu_torch.utils import bitnative as t_bitnative

ZOO = t_common.VROOM_ZOO
WIRE = t_decode.WIRE_ENGINES
BYTE_CODECS = ("vbyte", "maskedvbyte", "streamvbyte", "varintgb",
               "varintg8iu")
M32 = (1 << 32) - 1


def values(rng, n, top_bits=32, big=True):
    """Gaps with every byte length, 0 and 2^32 - 1 (below 2^top_bits)."""
    v = rng.integers(0, 1 << 10, size=n).astype(np.uint64)
    if big and n >= 4:
        v[rng.integers(0, n, max(1, n // 8))] = rng.integers(
            1 << 14, 1 << 27, max(1, n // 8))
        v[rng.integers(0, n, max(1, n // 16))] = rng.integers(
            1 << 28, 1 << 32, max(1, n // 16), dtype=np.uint64)
        v[0] = 0
        v[n // 2] = M32
    return (v & ((1 << top_bits) - 1)).astype(np.uint32)


def top_bits(codec):
    """The widest gap the codec takes in these tests: simple16 holds 28
    bits, and interpolative blocks (the partial blocks of the fixed-block
    codecs too) a u32 sum."""
    if codec in ("interpolative", "optpfor", "varintg8iu", "qmx"):
        return 22
    return {"simple16": 28}.get(codec, 32)


def cap_tail(codec, v):
    """v with the partial fixed-block tail of a whole list under 2^22
    (an interpolative block holds a u32 sum)."""
    if codec in ("optpfor", "varintg8iu", "interpolative"):
        v = v.copy()
        v[v.shape[0] // 256 * 256:] &= (1 << 22) - 1
    return v


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------


def test_tables_match_reference():
    assert t_common.VROOM_ZOO == j_common.VROOM_ZOO
    assert sorted(t_blocks.CODECS) == sorted(j_blocks.CODECS)
    assert t_blocks._S16_MODES == j_blocks._S16_MODES
    for a, b in zip(t_blocks._vgb_tables(), j_blocks._vgb_tables()):
        np.testing.assert_array_equal(a, b)
    assert t_qmx._ROW_SHIFTS == j_qmx._ROW_SHIFTS
    assert (t_qmx._INTS, t_qmx._TYPE, t_qmx._DOUBLE) == (
        j_qmx._INTS, j_qmx._TYPE, j_qmx._DOUBLE)
    assert t_vz.FIXED_BLOCK == j_vz.FIXED_BLOCK
    assert vars(t_ef.PARAMS) == vars(j_ef.PARAMS)
    assert (t_ef.CONF.eps1, t_ef.CONF.eps2, t_ef.CONF.fix_cost) == (
        j_ef.CONF.eps1, j_ef.CONF.eps2, j_ef.CONF.fix_cost)


@pytest.mark.parametrize("codec", sorted(t_blocks.CODECS))
def test_block_codecs_match_reference(codec):
    """Every block codec: the same bytes from the encoder, the same
    values and end position from the decoder, for full and partial
    blocks, with a known and an unknown sum."""
    rng = np.random.default_rng(len(codec))
    enc_t, dec_t = t_blocks.CODECS[codec]
    enc_j, dec_j = j_blocks.CODECS[codec]
    for n in (1, 3, 8, 100, 255, 256):
        v = values(rng, n, top_bits(codec))
        for s in (t_blocks.UNKNOWN, int(v.astype(np.int64).sum())):
            if codec == "interpolative" and s == t_blocks.UNKNOWN and n > 1:
                continue
            pay = enc_t(v, s)
            assert pay == enc_j(v, s)
            buf = np.frombuffer(b"\x07" + pay + b"\x00" * 8, np.uint8)
            got, end = dec_t(buf, 1, n, s)
            want, wend = dec_j(buf, 1, n, s)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, v)
            assert end == wend == 1 + len(pay)


@pytest.mark.parametrize("codec", ["maskedvbyte", "streamvbyte", "varintgb",
                                   "simple16", "optpfor", "varintg8iu"])
def test_numpy_decoders_match_reference(codec):
    """The numpy decoders the native walk falls back on."""
    rng = np.random.default_rng(7)
    name = {"varintg8iu": "_varint_g8iu_decode_numpy"}.get(
        codec, f"_{codec}_decode_numpy")
    for n in (1, 5, 256, 300):
        if codec in ("optpfor", "varintg8iu") and n != 256:
            continue
        v = values(rng, n, top_bits(codec))
        pay = np.frombuffer(t_blocks.CODECS[codec][0](v, t_blocks.UNKNOWN)
                            + b"\x00" * 8, np.uint8)
        got = getattr(t_blocks, name)(pay, 0, n, t_blocks.UNKNOWN)
        want = getattr(j_blocks, name)(pay, 0, n, j_blocks.UNKNOWN)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_qmx_payload_codec_matches_reference():
    rng = np.random.default_rng(3)
    for n in (2, 7, 64, 300, 5000):
        v = values(rng, n)
        v[: n // 3] = 1  # width-0 runs
        pay = t_qmx.encode(v)
        assert pay == j_qmx.encode(v)
        a = np.frombuffer(pay, np.uint8)
        np.testing.assert_array_equal(t_qmx.decode_payload(a, n), v)
        np.testing.assert_array_equal(t_qmx._decode_payload_numpy(a, n),
                                      j_qmx._decode_payload_numpy(a, n))


def test_native_truncation_falls_back():
    """A truncated buffer makes the native walk return None (the numpy
    decoder takes over), never read out of bounds."""
    rng = np.random.default_rng(45)
    v = values(rng, 500)
    for codec, fn in (("vbyte", "zoo_vbyte"), ("maskedvbyte",
                                               "zoo_maskedvbyte"),
                      ("streamvbyte", "zoo_streamvbyte"),
                      ("varintgb", "zoo_varintgb"),
                      ("simple16", "zoo_simple16")):
        vv = np.minimum(v, (1 << 28) - 1) if codec == "simple16" else v
        payload = t_blocks.CODECS[codec][0](vv, t_blocks.UNKNOWN)
        cut = payload[: len(payload) // 2]
        assert t_zn.decode(fn, cut, 0, 500) is None, codec
        assert j_zn.decode(fn, cut, 0, 500) is None, codec
    assert t_zn.decode("zoo_vbyte", [1, 2, 3], 0, 1) is None  # no buffer


def test_native_libraries_raise_with_the_build_error(monkeypatch):
    from dint_tpu_torch.utils import nativebuild

    monkeypatch.setattr(t_zn, "_lib", None)
    monkeypatch.setattr(t_bitnative, "_lib", None)
    monkeypatch.setattr(nativebuild, "ensure_so", lambda *a, **k: None)
    monkeypatch.setitem(nativebuild.errors, "libzoodec.so", "zoo boom")
    monkeypatch.setitem(nativebuild.errors, "libefdec.so", "ef boom")
    with pytest.raises(RuntimeError, match="zoo boom"):
        t_zn.get_lib()
    with pytest.raises(RuntimeError, match="ef boom"):
        t_bitnative.get_lib()


@pytest.mark.parametrize("codec", [c for c in ZOO if c != "pef"])
def test_whole_list_codecs_match_reference(codec):
    """encode_list_zoo's bytes and chunk lengths; decode_list_zoo across
    chunk boundaries and partial fixed-block tails; each package reads
    the other's payload."""
    rng = np.random.default_rng(11)
    for n in (1, 2, 255, 256, 777, OPT_CHUNK + 300):
        g = cap_tail(codec, values(
            rng, n, {"interpolative": 22, "simple16": 28}.get(codec, 32)))
        pay, lens = t_vz.encode_list_zoo(codec, g)
        assert (pay, lens) == j_vz.encode_list_zoo(codec, g)
        arena = np.frombuffer(b"\x01\x02" + pay, np.uint8)
        np.testing.assert_array_equal(
            t_vz.decode_list_zoo(codec, arena, 2, n), g)
        np.testing.assert_array_equal(
            j_vz.decode_list_zoo(codec, arena, 2, n), g)


def test_pef_lists_match_reference():
    rng = np.random.default_rng(12)
    for n in (1, 2, 130, 3000):
        docs = np.sort(rng.choice(5_000_000, size=n, replace=False)).astype(
            np.uint64)
        body, bits = t_vz.encode_list_pef(docs)
        assert (body, bits) == j_vz.encode_list_pef(docs)
        arena = np.frombuffer(body, np.uint8)
        u = int(docs[-1]) + 1
        np.testing.assert_array_equal(
            t_vz.decode_list_pef(arena, 0, len(body), n, u), docs)
    cluster = 1_000_000 + np.arange(600, dtype=np.uint64) * 2
    body, _ = t_vz.encode_list_pef(cluster)
    assert body == j_vz.encode_list_pef(cluster)[0]


def test_ef_python_paths_match_reference():
    """The numpy decode and the python partitioning DP (the oracles of
    the native EF library) against the reference's, and the native DP
    against the python one."""
    rng = np.random.default_rng(13)
    docs = np.sort(rng.choice(200_000, size=2000, replace=False)).astype(
        np.uint64)
    u = int(docs[-1]) + 1
    seq = t_ef.partitioned_sequence(t_ef.indexed_sequence)
    cost = lambda uu, m: (t_ef.indexed_sequence.bitsize(t_ef.PARAMS, uu, m)
                          + t_ef.CONF.fix_cost)
    jcost = lambda uu, m: (j_ef.indexed_sequence.bitsize(j_ef.PARAMS, uu, m)
                           + j_ef.CONF.fix_cost)
    part = t_ef.optimal_partition(docs, u, cost, t_ef.CONF.eps1,
                                  t_ef.CONF.eps2)
    assert part == j_ef.optimal_partition(docs, u, jcost, j_ef.CONF.eps1,
                                          j_ef.CONF.eps2)
    assert part == seq._partition_points(docs, u, docs.shape[0],
                                         t_ef.PARAMS)
    bb = t_bitio.BitBuilder()
    seq.write(bb, docs, u, docs.shape[0], t_ef.PARAMS)
    words = bb.words()
    np.testing.assert_array_equal(
        seq.decode_all(words, 0, u, docs.shape[0], t_ef.PARAMS), docs)
    jseq = j_ef.partitioned_sequence(j_ef.indexed_sequence)
    np.testing.assert_array_equal(
        jseq.decode_all(words, 0, u, docs.shape[0], j_ef.PARAMS), docs)
    np.testing.assert_array_equal(
        t_bitio.ones_positions(words, 3, 900),
        j_bitio.ones_positions(words, 3, 900))
    pos = np.arange(5, 800, 7, dtype=np.uint64)
    np.testing.assert_array_equal(t_bitio.read_fields(words, pos, 9),
                                  j_bitio.read_fields(words, pos, 9))


# ---------------------------------------------------------------------------
# streams: encode_zoo, cross reads, the decode tool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A small collection and every zoo type encoded by both packages:
    ({type: (port stream, reference stream)}, collection basename)."""
    tmp = str(tmp_path_factory.mktemp("torch_zoo"))
    base = os.path.join(tmp, "zc")
    docs, freqs = j_synth.make_collection(50, 30000, seed=29, avg_len=150)
    j_collection.write_freq_collection(base, docs, freqs, 30000)
    out = {}
    for t in ZOO:
        mine, ref = os.path.join(tmp, f"t.{t}"), os.path.join(tmp, f"j.{t}")
        t_encode.encode_zoo(t, base + ".docs", mine)
        j_encode.encode_zoo(t, base + ".docs", ref)
        out[t] = (mine, ref)
    return out, base


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("type_name", ZOO)
def test_encode_zoo_writes_the_reference_bytes(zoo, type_name, tmp_path):
    mine, ref = zoo[0][type_name]
    assert _bytes(mine) == _bytes(ref)
    a = np.load(mine + ".skips.npz")
    b = np.load(ref + ".skips.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    # the process pool writes the same bytes
    pooled = str(tmp_path / "pooled")
    t_encode.encode_zoo(type_name, zoo[1] + ".docs", pooled, workers=2)
    assert _bytes(pooled) == _bytes(mine)


def test_encode_zoo_many_writes_the_reference_bytes(zoo, tmp_path):
    """Every zoo type encoded in one process pool: each stream and skip
    sidecar is the reference's."""
    outs = {t: str(tmp_path / f"many.{t}") for t in ZOO}
    recs = t_encode.encode_zoo_many(outs, zoo[1] + ".docs", workers=2)
    assert list(recs) == list(ZOO)
    for t in ZOO:
        ref = zoo[0][t][1]
        assert _bytes(outs[t]) == _bytes(ref), t
        a = np.load(outs[t] + ".skips.npz")
        b = np.load(ref + ".skips.npz")
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("type_name", ZOO)
def test_each_package_reads_the_others_stream(zoo, type_name):
    mine, ref = zoo[0][type_name]
    expect = t_decode._expected_lists(type_name, zoo[1] + ".docs")
    for path, stream_mod, vz in ((ref, t_stream, t_vz), (mine, j_stream,
                                                         j_vz)):
        arena, meta = stream_mod.load_stream(path)
        for i, e in enumerate(expect):
            if type_name == "pef":
                got = vz.decode_list_pef(arena, int(meta.payload_off[i]),
                                         int(meta.payload_len[i]),
                                         int(meta.n[i]),
                                         int(meta.universe[i]))
            else:
                got = vz.decode_list_zoo(type_name, arena,
                                         int(meta.payload_off[i]),
                                         int(meta.n[i]))
            np.testing.assert_array_equal(got, e)


def _cli(capsys, argv):
    t_decode.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("type_name", ZOO)
def test_cli_device_ladder_checks_ok(zoo, type_name, capsys):
    mine, _ = zoo[0][type_name]
    rec = _cli(capsys, [type_name, mine, "--runs", "2", "--device", "cpu",
                        "--check-collection", zoo[1] + ".docs"])
    assert rec["check"] == "ok" and rec["engine"] == "device"
    assert rec["device"] == "cpu" and rec["wire"] is False
    jrec = j_decode.decode_zoo_device(type_name, mine, 1)
    assert rec["plan_bytes"] == jrec["plan_bytes"]
    assert set(rec) == set(jrec) | {"check", "wire", "device"}


@pytest.mark.parametrize("type_name", WIRE)
def test_cli_device_wire_checks_ok(zoo, type_name, capsys, monkeypatch):
    mine, _ = zoo[0][type_name]
    rec = _cli(capsys, [type_name, mine, "--engine", "device", "--wire",
                        "--runs", "2", "--device", "cpu",
                        "--check-collection", zoo[1] + ".docs"])
    assert rec["check"] == "ok" and rec["wire"] is True
    monkeypatch.setenv("DINT_TPU_WIRE_UNPACK", "1")
    jrec = j_decode.decode_zoo_device(type_name, mine, 1)
    assert rec["plan_bytes"] == jrec["plan_bytes"]


@pytest.mark.parametrize("type_name", ZOO)
def test_cli_host_checks_ok(zoo, type_name, capsys):
    mine, _ = zoo[0][type_name]
    rec = _cli(capsys, [type_name, mine, "--engine", "host", "--runs", "1",
                        "--check-collection", zoo[1] + ".docs"])
    assert rec["check"] == "ok" and rec["engine"] == "host"


def test_cli_encode_zoo_and_engine_choices(zoo, tmp_path, capsys):
    out = str(tmp_path / "cli.qmx")
    t_encode.main(["qmx", zoo[1] + ".docs", "--out", out])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["type"] == "qmx" and _bytes(out) == _bytes(zoo[0]["qmx"][0])
    with pytest.raises(SystemExit):
        t_decode.main(["qmx", out, "--engine", "raw", "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_decode.main(["single_rect_dint", out, "--engine", "host"])


def test_zoo_device_default_raises_without_cuda(zoo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_decode.decode_zoo_device("vbyte", zoo[0]["vbyte"][0], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_decode.main(["vbyte", zoo[0]["vbyte"][0], "--runs", "1"])


# ---------------------------------------------------------------------------
# device engines (the reference's zoo device tests, engine against engine)
# ---------------------------------------------------------------------------


def write_lists(path, codec, lists):
    if codec == "pef":
        payloads = [j_vz.encode_list_pef(d)[0] for d in lists]
        j_stream.write_stream(path, payloads, [len(d) for d in lists],
                              [int(d[-1]) + 1 for d in lists],
                              [[len(p)] for p in payloads])
    else:
        payloads = [j_vz.encode_list_zoo(codec, g)[0] for g in lists]
        j_stream.write_stream(path, payloads, [len(g) for g in lists],
                              [int(g.astype(np.int64).sum()) for g in lists])
    return t_stream.load_stream(path)


def assert_plans_equal(got, want):
    assert got.codec == want.codec and got.total_ints == want.total_ints
    assert len(got.classes) == len(want.classes)
    for g, w in zip(got.classes, want.classes):
        assert g.b == w.b
        for f in ("payload", "out_base", "size", "exc_dense", "val_base",
                  "prepacked"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.partials) == len(want.partials)
    for (o, v), (p, u) in zip(got.partials, want.partials):
        assert o == p
        np.testing.assert_array_equal(v, u)


def optpfor_qmx_lists():
    rng = np.random.default_rng(31)
    lists = []
    for n in (1, 40, 256, 300, 1000, 777):
        mag = int(rng.integers(2, 26))
        lists.append(rng.integers(0, 1 << mag, n).astype(np.uint32))
    v = rng.integers(0, 64, 512).astype(np.uint32)
    v[rng.choice(512, 20, replace=False)] = rng.integers(1 << 20, 1 << 30, 20)
    lists.append(v)
    ones = np.ones(700, np.uint32)  # qmx width-0 instances
    ones[::97] = 5
    lists.append(ones)
    return lists


def replay_unpack_chain(eng, runs):
    """Numpy replay of UnpackEngine.chain from the engine's own image
    arrays: per run, each class's sampled lanes unpacked in numpy,
    salted, summed mod 2^32, minus salt * count."""
    pvals = np.concatenate([v for _, v in eng.plan.partials]
                           or [np.zeros(0, np.uint32)]).astype(np.uint64)
    salt = 1
    for _ in range(runs):
        s, cnt = 0, 0
        for kind, b, a0, a1 in eng._dev:
            out = np.asarray(t_ud._kind_fns(kind, b)(
                a0, a1, torch.zeros((), dtype=torch.int32)
            ).numpy().view(np.uint32), np.uint64)
            samp = out[:1, :1, :8]
            s += int(samp.sum()) + salt * samp.size
            cnt += samp.size
        s += int(pvals.sum()) + salt * pvals.size
        cnt += pvals.size
        salt = (s - salt * cnt) & M32
    return salt


@pytest.mark.parametrize("codec", ["optpfor", "qmx"])
def test_device_unpack_engine_exact(tmp_path, codec):
    """optpfor and qmx through their planners and UnpackEngine: the
    plan equals the reference's, the decode the reference engine's and
    the lists, and the chain checksum a numpy replay."""
    lists = optpfor_qmx_lists()
    arena, meta = write_lists(str(tmp_path / f"s.{codec}"), codec, lists)
    tplan = getattr(t_ud, f"plan_{codec}")(arena, meta)
    jplan = getattr(j_ud, f"plan_{codec}")(arena, meta)
    assert_plans_equal(tplan, jplan)
    teng = t_ud.UnpackEngine(tplan, device="cpu")
    jeng = j_ud.UnpackEngine(jplan)
    got = teng.decode_all_ordered()
    np.testing.assert_array_equal(got, jeng.decode_all_ordered())
    np.testing.assert_array_equal(got, np.concatenate(lists))
    assert teng.device_bytes == sum(
        int(a0.nbytes) + (int(a1.nbytes) if a1 is not None else 0)
        for kind, b, a0, a1 in jeng._dev if not (kind == "qmx" and b == 0))
    assert [d[:2] for d in teng._dev] == [d[:2] for d in jeng._dev]
    assert teng.timed_chain(3) >= 0
    assert teng.final_checksum == replay_unpack_chain(teng, 3)


def test_device_unpack_b0_class_with_exceptions(tmp_path):
    """optpfor blocks of width 0 whose values are all exceptions: the
    engine applies their exception highs."""
    rng = np.random.default_rng(3)
    g = np.zeros(512, np.uint32)
    g[rng.choice(512, 6, replace=False)] = 1
    arena, meta = write_lists(str(tmp_path / "s.optpfor"), "optpfor", [g])
    plan = t_ud.plan_optpfor(arena, meta)
    assert plan.classes[0].b == 0 and plan.classes[0].exc_dense.shape[0]
    eng = t_ud.UnpackEngine(plan, device="cpu")
    np.testing.assert_array_equal(eng.decode_all_ordered(), g)
    np.testing.assert_array_equal(
        eng.decode_all_ordered(),
        j_ud.UnpackEngine(j_ud.plan_optpfor(arena, meta)).decode_all_ordered())


def test_simple16_device_engine_exact(tmp_path):
    rng = np.random.default_rng(13)
    lists = []
    for n in (1, 29, 255, 1000, OPT_CHUNK + 137, 3):
        mag = int(rng.integers(1, 27))
        lists.append(rng.integers(0, 1 << mag, n).astype(np.uint32))
    lists.append(np.full(60, (1 << 28) - 1, np.uint32))  # mode 8, bit 31
    arena, meta = write_lists(str(tmp_path / "s.simple16"), "simple16", lists)
    tplan = t_ud.plan_simple16(arena, meta)
    jplan = j_ud.plan_simple16(arena, meta)
    for a, b in zip(tplan.classes, jplan.classes):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            np.testing.assert_array_equal(x, y)
    eng = t_ud.Simple16Engine(tplan, device="cpu")
    got = eng.decode_all_ordered()
    np.testing.assert_array_equal(got, np.concatenate(lists))
    np.testing.assert_array_equal(
        got, j_ud.Simple16Engine(jplan).decode_all_ordered())
    jouts = j_ud.Simple16Engine(jplan).decode_classes()
    for mode, vals in eng.decode_classes().items():
        np.testing.assert_array_equal(vals, jouts[mode])
    # chain checksum against a numpy replay
    eng.timed_chain(3)
    salt = 1
    for _ in range(3):
        s, cnt = 0, 0
        for _, c, bits, _, w in eng._dev:
            words = w.numpy().view(np.uint32).astype(np.uint64)[:8]
            sh = (np.arange(c, dtype=np.uint64) * np.uint64(bits))
            f = (words[:, None, :] >> sh[None, :, None]) & np.uint64(
                (1 << bits) - 1)
            s += int(f.sum()) + salt * f.size
            cnt += f.size
        salt = (s - salt * cnt + salt + 1) & M32
    assert eng.final_checksum == salt


@pytest.mark.parametrize("codec", ["qmx", "simple16", "optpfor", "vbyte",
                                   "u32", "interpolative", "varintgb"])
def test_ladder_device_engine_exact(tmp_path, codec):
    rng = np.random.default_rng(47)
    lists = []
    for n in (1, 40, 256, 300, 1000, 777, 3):
        mag = int(rng.integers(1, 22))
        lists.append(rng.integers(0, 1 << mag, n).astype(np.uint32))
    big_mag = 22 if codec == "interpolative" else 27
    lists.append(rng.integers(0, 1 << big_mag, 512).astype(np.uint32))
    lists.append(np.zeros(512, np.uint32))
    arena, meta = write_lists(str(tmp_path / f"s.{codec}"), codec, lists)
    tplan = t_ud.plan_ladder(codec, arena, meta)
    assert_plans_equal(tplan, j_ud.plan_ladder(codec, arena, meta))
    eng = t_ud.UnpackEngine(tplan, device="cpu")
    np.testing.assert_array_equal(eng.decode_all_ordered(),
                                  np.concatenate(lists), err_msg=codec)
    assert eng.device_bytes > 0
    eng.timed_chain(2)
    assert eng.final_checksum == replay_unpack_chain(eng, 2)


def test_pef_ladder_device_engine_exact(tmp_path):
    rng = np.random.default_rng(53)
    lists = [np.sort(rng.choice(5_000_000, size=n, replace=False)).astype(
        np.uint32) for n in (1, 40, 256, 999, 3000)]
    lists.append(1_000_000 + np.arange(512, dtype=np.uint32) * 2)
    arena, meta = write_lists(str(tmp_path / "s.pef"), "pef", lists)
    plan = t_ud.plan_ladder("pef", arena, meta)
    assert_plans_equal(plan, j_ud.plan_ladder("pef", arena, meta))
    eng = t_ud.UnpackEngine(plan, device="cpu")
    np.testing.assert_array_equal(eng.decode_all_ordered(),
                                  np.concatenate(lists))
    assert any(c.val_base is not None for c in plan.classes)
    assert min(c.b for c in plan.classes) <= 16
    eng.timed_chain(2)
    assert eng.final_checksum == replay_unpack_chain(eng, 2)


@pytest.mark.parametrize("codec", BYTE_CODECS)
def test_byteclass_device_engine_exact(tmp_path, codec):
    rng = np.random.default_rng(21)
    lists = [cap_tail(codec, values(rng, n))
             for n in (1, 40, 255, 1000, OPT_CHUNK + 77)]
    arena, meta = write_lists(str(tmp_path / f"s.{codec}"), codec, lists)
    tplan = t_ud.plan_byteclass(codec, arena, meta)
    jplan = j_ud.plan_byteclass(codec, arena, meta)
    assert (tplan.codec, tplan.group_bits, tplan.total_ints) == (
        jplan.codec, jplan.group_bits, jplan.total_ints)
    for a, b in zip(tplan.classes, jplan.classes):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert len(tplan.partials) == len(jplan.partials)
    eng = t_ud.ByteClassEngine(tplan, device="cpu")
    got = eng.decode_all_ordered()
    np.testing.assert_array_equal(got, np.concatenate(lists), err_msg=codec)
    np.testing.assert_array_equal(
        got, j_ud.ByteClassEngine(jplan).decode_all_ordered())
    assert (got >= 1 << 31).any()
    # chain checksum against a numpy replay
    eng.timed_chain(3)
    mask = 0xFF if tplan.group_bits == 8 else 0x7F
    pv = np.concatenate([v for _, v in tplan.partials]
                        or [np.zeros(0, np.uint32)]).astype(np.uint64)
    salt = 1
    for _ in range(3):
        s, cnt = 0, 0
        for L, b, _ in tplan.classes:
            if not b.shape[0]:
                continue
            v = np.zeros(min(8, b.shape[0]), np.uint64)
            for i in range(L):
                v |= (b[:8, i].astype(np.uint64) & np.uint64(mask)) << \
                    np.uint64(tplan.group_bits * i)
            s += int((v & np.uint64(M32)).sum()) + salt * v.size
            cnt += v.size
        s += int(pv.sum()) + salt * pv.size
        cnt += pv.size
        salt = (s - salt * cnt + salt + 1) & M32
    assert eng.final_checksum == salt


@pytest.mark.parametrize("salt", [0, 1, 0x80000000, M32])
@pytest.mark.parametrize("w", [0, 1, 3, 7, 8, 9, 12, 16, 21, 32])
def test_qmx_unpack_shifts_are_logical(w, salt):
    """Lane words with bit 31 set in every lane: the spill rows of the
    double-word widths (7, 9, 12, 21) OR the low word's shifted bits
    with the high word's, so their right shift must be logical."""
    rng = np.random.default_rng(w + 1)
    lo = rng.integers(0, 1 << 32, size=(4, 3, 128), dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=(4, 3, 128), dtype=np.uint64)
    lo, hi = (lo | (1 << 31)).astype(np.uint32), (hi | (1 << 31)).astype(
        np.uint32)
    double = w in (7, 9, 12, 21)
    jhi = jnp.asarray(hi) if double else None
    want = np.asarray(j_ud._qmx_fns(w)[0](jnp.asarray(lo), jhi,
                                          jnp.uint32(salt)))
    s32 = torch.tensor(salt - (1 << 32) if salt >= 1 << 31 else salt,
                       dtype=torch.int32)
    got = t_ud._qmx_fns(w)(torch.from_numpy(lo.view(np.int32)),
                           torch.from_numpy(hi.view(np.int32))
                           if double else None, s32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("gb", [7, 8])
def test_byteclass_unpack_matches_reference(L, gb):
    rng = np.random.default_rng(L * gb)
    b = rng.integers(0, 256, size=(300, L)).astype(np.uint8)
    b[::3] |= 0x80
    want = np.asarray(j_ud._byteclass_fns(L, gb)[0](
        tuple(jnp.asarray(np.ascontiguousarray(b[:, i])) for i in range(L)),
        np.uint32(0)))
    got = t_ud._byteclass_unpack(torch.from_numpy(b), gb, 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("b", [1, 3, 5, 7, 11, 17, 31, 32])
def test_phase_unpack_matches_reference(b):
    rng = np.random.default_rng(b)
    words = rng.integers(0, 1 << 32, size=(9, 8 * b), dtype=np.uint64).astype(
        np.uint32)
    assert t_ud._phase_geometry(b, 256) == j_ud._phase_geometry(b, 256)
    np.testing.assert_array_equal(t_ud._np_phase_unpack(words, b, 256),
                                  j_ud._np_phase_unpack(words, b, 256))


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError, match="not in"):
        t_ud.UnpackEngine(t_ud.UnpackPlan("simple16", 256, [], [], 0),
                          device="cpu")
    with pytest.raises(ValueError, match="zoo type"):
        t_decode.zoo_device_engine("single_rect_dint", None, None,
                                   device="cpu")
