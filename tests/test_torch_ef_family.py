"""The port's Elias-Fano family against the reference's.

Every sequence writer of ``codecs/ef`` (compact EF, ranked bitvector,
indexed, strict, positive, partitioned and uniform partitioned) must
write the reference's words bit for bit from a misaligned start; every
enumerator of ``codecs/ef_enum`` must walk the same values and
positions under one script of move / next / next_geq / prev_value
calls; the four EF index kinds (ef, single, uniform, opt) must save the
reference's files byte for byte, each package loading the other's; and
``ef_device.decode_lists`` on the CPU must equal the reference's (JAX on
the CPU) and the host decode int for int, at w = 0, n = 1, lists at a
power-of-two boundary and high words with bit 31 set.  Models:
tests/test_ef_family.py:184-230.
"""

import os

import numpy as np
import pytest

from dint_tpu.codecs import ef as j_ef
from dint_tpu.codecs import ef_device as j_efd
from dint_tpu.codecs import ef_enum as j_enum
from dint_tpu.index import freq_index as j_fi
from dint_tpu.utils.bitio import BitBuilder as JBitBuilder
from dint_tpu_torch.codecs import ef as t_ef
from dint_tpu_torch.codecs import ef_device as t_efd
from dint_tpu_torch.codecs import ef_enum as t_enum
from dint_tpu_torch.index import freq_index as t_fi
from dint_tpu_torch.io import collection, synth
from dint_tpu_torch.tools import create_freq_index as t_cfi
from dint_tpu_torch.utils.bitio import BitBuilder as TBitBuilder

EF_KINDS = ("ef", "single", "uniform", "opt")
# (n, universe): all-ones, one value, dense, sampling multiples, sparse,
# several partitions, a universe past 2^31
CASES = [(5, 5), (1, 1), (1, 9), (300, 330), (256, 1024), (512, 40_000),
         (1500, 6000), (120, (1 << 31) + 77)]


def seqs(pkg):
    return {
        "compact_ef": pkg.compact_elias_fano,
        "ranked_bitvector": pkg.compact_ranked_bitvector,
        "indexed": pkg.indexed_sequence,
        "strict_ef": pkg.strict_elias_fano,
        "strict": pkg.strict_sequence,
        "partitioned": pkg.partitioned_sequence(pkg.indexed_sequence),
        "partitioned_strict": pkg.partitioned_sequence(pkg.strict_sequence),
        "uniform": pkg.uniform_partitioned_sequence(pkg.indexed_sequence),
        "uniform_strict": pkg.uniform_partitioned_sequence(
            pkg.strict_sequence),
    }


def values(n, universe, seed):
    if n == universe:
        return np.arange(n, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    if universe > 1 << 24:
        v = np.unique(rng.integers(0, universe, n + n // 4 + 4,
                                   dtype=np.uint64))[:n]
        v[-1] = universe - 1
        return np.sort(v)
    return np.sort(rng.choice(universe, size=n, replace=False)).astype(
        np.uint64)


def write_both(name, v, universe, n, lead=3):
    """(reference words, port words, offset) of one sequence written
    after ``lead`` bits by each package."""
    out = []
    for pkg, bb in ((j_ef, JBitBuilder()), (t_ef, TBitBuilder())):
        bb.append_bits(5, lead)
        seqs(pkg)[name].write(bb, v, universe, n, pkg.PARAMS)
        out.append((bb.words(), bb.size))
    (jw, js), (tw, ts) = out
    assert js == ts
    return jw, tw, lead


@pytest.mark.parametrize(
    "name,case",
    # a ranked bitvector spends a bit per universe value: no 2^31 there
    [(name, c) for name in sorted(seqs(t_ef)) for c in CASES
     if name != "ranked_bitvector" or c[1] < 1 << 24],
    ids=lambda x: x if isinstance(x, str) else f"n{x[0]}_u{x[1]}")
def test_writers_bit_equal_and_decode(name, case):
    n, universe = case
    v = values(n, universe, n + universe % 97)
    jw, tw, off = write_both(name, v, universe, n)
    np.testing.assert_array_equal(tw, jw)
    got = seqs(t_ef)[name].decode_all(tw, off, universe, n, t_ef.PARAMS)
    np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("base", ["strict", "strict_ef", "partitioned_strict",
                                  "uniform_strict"])
@pytest.mark.parametrize("n", [1, 64, 700])
def test_positive_sequences_bit_equal(base, n):
    v = np.random.default_rng(n).integers(1, 40, n).astype(np.uint64)
    universe = int(v.sum()) + 1
    words = []
    for pkg, bb in ((j_ef, JBitBuilder()), (t_ef, TBitBuilder())):
        bb.append_bits(1, 1)
        pkg.positive_sequence(seqs(pkg)[base]).write(bb, v, universe, n,
                                                     pkg.PARAMS)
        words.append(bb.words())
    np.testing.assert_array_equal(words[1], words[0])
    got = t_ef.positive_sequence(seqs(t_ef)[base]).decode_all(
        words[1], 1, universe, n, t_ef.PARAMS)
    np.testing.assert_array_equal(got, v)


def test_strict_params_disable_zero_sampling():
    sp = t_ef._strict_params(t_ef.PARAMS)
    assert sp.__dict__ == j_ef._strict_params(j_ef.PARAMS).__dict__
    assert t_ef.PARAMS.ef_log_sampling0 != 63  # the copy, not the original


# ---------------------------------------------------------------------------
# Enumerators
# ---------------------------------------------------------------------------


def script(n, universe, seed, steps=60):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        r = rng.random()
        if r < 0.3:
            ops.append(("move", int(rng.integers(0, n + 2))))
        elif r < 0.55:
            ops.append(("next",))
        elif r < 0.85:
            ops.append(("next_geq", int(rng.integers(0, universe + 2))))
        else:
            ops.append(("prev_value",))
    return ops


def walk(e, ops):
    trace = []
    for op in ops:
        if not hasattr(e, op[0]):
            continue
        res = getattr(e, op[0])(*op[1:])
        trace.append((op, int(res), e.position(),
                      int(e.value()) if hasattr(e, "value") else None))
    return trace


def enumerators(pkg):
    return {
        "ef": ("compact_ef", lambda w, o, u, n, p: pkg.EFEnumerator(
            w, o, u, n, p)),
        "rb": ("ranked_bitvector", lambda w, o, u, n, p: pkg.RBEnumerator(
            w, o, u, n, p)),
        "indexed": ("indexed", pkg.indexed_enumerator),
        "strict_ef": ("strict_ef", pkg.StrictEFEnumerator),
        "strict": ("strict", pkg.StrictSeqEnumerator),
        "partitioned": ("partitioned", lambda w, o, u, n, p:
                        pkg.PartitionedEnumerator(w, o, u, n, p)),
        "partitioned_strict": ("partitioned_strict", lambda w, o, u, n, p:
                               pkg.PartitionedEnumerator(
                                   w, o, u, n, p, base="strict")),
        "uniform": ("uniform", lambda w, o, u, n, p:
                    pkg.PartitionedEnumerator(w, o, u, n, p, uniform=True)),
    }


@pytest.mark.parametrize("case", [(5, 5), (1, 9), (300, 330), (256, 1024),
                                  (1500, 6000)],
                         ids=lambda c: f"n{c[0]}_u{c[1]}")
@pytest.mark.parametrize("kind", sorted(enumerators(t_enum)))
def test_enumerators_walk_like_the_reference(kind, case):
    n, universe = case
    name, _ = enumerators(t_enum)[kind]
    v = values(n, universe, 11 + n)
    jw, tw, off = write_both(name, v, universe, n)
    ops = script(n, universe, n + len(kind))
    if kind == "partitioned_strict":
        # positional access only: strict partitions have no next_geq, in
        # either package (freqs are read by position)
        ops = [op for op in ops if op[0] != "next_geq"]
    te = enumerators(t_enum)[kind][1](tw, off, universe, n, t_ef.PARAMS)
    je = enumerators(j_enum)[kind][1](jw, off, universe, n, j_ef.PARAMS)
    got = walk(te, ops)
    assert len(got) > 20
    assert got == walk(je, ops)
    if hasattr(te, "value"):  # a fresh forward scan reads every value
        e = enumerators(t_enum)[kind][1](tw, off, universe, n, t_ef.PARAMS)
        seen = [e.move(0)] + [e.next() for _ in range(n - 1)]
        np.testing.assert_array_equal(np.asarray(seen, np.uint64), v)


def test_next_reader_matches_reference():
    n, universe = 900, 50_000
    v = values(n, universe, 4)
    jw, tw, off = write_both("compact_ef", v, universe, n)
    te = t_enum.EFEnumerator(tw, off, universe, n, t_ef.PARAMS)
    je = j_enum.EFEnumerator(jw, off, universe, n, j_ef.PARAMS)
    te.move(17)
    je.move(17)
    for start in (0, 255, 256, 899, 900):
        tr, jr = te.next_reader(start), je.next_reader(start)
        got = [tr() for _ in range(5)]
        assert got == [jr() for _ in range(5)]
        if start < n:
            assert got[0] == int(v[start])
    assert te.position() == 17  # the reader leaves the enumerator alone


# ---------------------------------------------------------------------------
# The index files and their readers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def collection_base(tmp_path_factory):
    """24 lists over 20,000 docs with a single-posting list; returns
    (basename, docs, freqs)."""
    root = str(tmp_path_factory.mktemp("torch_ef"))
    base = os.path.join(root, "c")
    docs, freqs = synth.make_collection(24, 20_000, seed=41, avg_len=300)
    docs[3], freqs[3] = docs[3][:1], freqs[3][:1]
    collection.write_freq_collection(base, docs, freqs, 20_000)
    return base, docs, freqs


@pytest.fixture(scope="module")
def ef_files(collection_base, tmp_path_factory):
    """{kind: (port file, reference file)}, each built by its package."""
    base = collection_base[0]
    root = str(tmp_path_factory.mktemp("torch_ef_files"))
    out = {}
    for kind in EF_KINDS:
        tp, jp = (os.path.join(root, f"{w}_{kind}.npz") for w in "tj")
        t_fi.build_freq_index(base, kind).save(tp)
        j_fi.build_freq_index(base, kind).save(jp)
        out[kind] = (tp, jp)
    return out


@pytest.mark.parametrize("kind", EF_KINDS)
def test_index_files_byte_equal_and_cross_load(collection_base, ef_files,
                                               kind):
    base = collection_base[0]
    tp, jp = ef_files[kind]
    a, b = np.load(tp), np.load(jp)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    ti, ji = t_fi.FreqIndexEF.load(jp), j_fi.FreqIndexEF.load(tp)
    t_fi.verify_freq_index(ti, base)
    j_fi.verify_freq_index(ji, base)
    assert ti.size_stats() == ji.size_stats()
    np.testing.assert_array_equal(ti.list_n, ji.list_n)


@pytest.mark.parametrize("kind", EF_KINDS)
def test_create_freq_index_cli_stats_and_check(collection_base, tmp_path,
                                               capsys, kind):
    import json

    out = str(tmp_path / "idx.npz")
    idx = t_cfi.main([kind, collection_base[0], out, "--check"])
    (line,) = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert json.loads(line) == {"type": kind, **idx.size_stats()}
    assert np.load(out)["docs_words"].tobytes() == idx.docs.words.tobytes()


@pytest.mark.parametrize("kind", EF_KINDS)
def test_cursors_walk_like_the_reference(ef_files, collection_base, kind):
    """EFListCursor through EFLazyCache: docid, freq and position after
    next / next_geq steps, and the cache counters."""
    tp, _ = ef_files[kind]
    tc = t_fi.EFLazyCache(t_fi.FreqIndexEF.load(tp))
    jc = j_fi.EFLazyCache(j_fi.FreqIndexEF.load(tp))
    docs = collection_base[1]
    rng = np.random.default_rng(len(kind))
    for term in range(len(docs)):
        tcur, jcur = tc.make_cursor(term), jc.make_cursor(term)
        assert tcur.size == jcur.size == docs[term].shape[0]
        for _ in range(12):
            if rng.random() < 0.4:
                tcur.next()
                jcur.next()
            else:
                lb = int(rng.integers(0, 20_001))
                tcur.next_geq(lb)
                jcur.next_geq(lb)
            assert tcur.docid() == jcur.docid()
            assert tcur.position() == jcur.position()
            if tcur.position() < tcur.size:
                assert tcur.freq() == jcur.freq()
    assert (tc.moves, tc.freq_lists_opened) == (jc.moves, jc.freq_lists_opened)


# ---------------------------------------------------------------------------
# ef_device
# ---------------------------------------------------------------------------


def device_arena():
    """Lists in one misaligned arena: w = 0, n = 1, n and universe at
    powers of two (fields ending on a word boundary), a universe near
    2^32; returns (words, specs, values)."""
    bb = TBitBuilder()
    bb.append_bits(0x5A5A5, 37)
    specs, vals = [], []
    for n, universe in [(1, 1), (1, 1000), (7, 7), (200, 300), (256, 256),
                        (256, 1 << 16), (1024, 1 << 20), (513, 1 << 9 + 1),
                        (333, (1 << 32) - 1), (4000, 9000)]:
        v = values(n, universe, n ^ universe)
        specs.append((bb.size, universe, n))
        t_ef.compact_elias_fano.write(bb, v, universe, n, t_ef.PARAMS)
        vals.append(v)
    return bb.words(), specs, vals


def test_ef_device_decode_matches_reference_and_host():
    words, specs, vals = device_arena()
    got = t_efd.decode_lists(words, specs, t_ef.PARAMS, device="cpu")
    ref = j_efd.decode_lists(words, specs, j_ef.PARAMS)
    seen_w0 = seen_bit31 = False
    w32 = words.view("<u4")
    for g, r, v, (off, universe, n) in zip(got, ref, vals, specs):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, r, err_msg=f"u={universe} n={n}")
        np.testing.assert_array_equal(g, v)
        np.testing.assert_array_equal(
            t_ef.compact_elias_fano.decode_all(words, off, universe, n,
                                               t_ef.PARAMS), v)
        of = t_ef.ef_offsets(off, universe, n, t_ef.PARAMS)
        seen_w0 |= of.lower_bits == 0
        hw = w32[of.higher_bits_offset >> 5:
                 (of.higher_bits_offset + of.higher_bits_length) >> 5]
        seen_bit31 |= bool((hw >> 31).any())
    assert seen_w0 and seen_bit31
    assert t_efd.decode_lists(words, [], t_ef.PARAMS, device="cpu") == []


def test_ef_device_refuses_universes_past_u32():
    bb = TBitBuilder()
    t_ef.compact_elias_fano.write(bb, np.asarray([3], np.uint64), 1 << 32, 1,
                                  t_ef.PARAMS)
    with pytest.raises(AssertionError, match="u32"):
        t_efd.decode_lists(bb.words(), [(0, 1 << 32, 1)], t_ef.PARAMS,
                           device="cpu")


@pytest.mark.parametrize("kind", EF_KINDS)
def test_term_decoder_device_ef(ef_files, collection_base, kind):
    """``device_ef=True`` decodes a plain-EF index's docids through
    ef_device (and only that kind's), equal to the reference's device
    decode and to the collection; freqs stay host decodes."""
    tp, _ = ef_files[kind]
    ti, ji = t_fi.FreqIndexEF.load(tp), j_fi.FreqIndexEF.load(tp)
    dec = t_fi.EFTermDecoder(ti, device="cpu", device_ef=True)
    assert dec.device_ef == (kind == "ef")
    terms = list(range(ti.num_lists))[::-1]
    got = dec.decode_docids(terms)
    want = j_fi.EFTermDecoder(ji, device_ef=True).decode_docids(terms)
    freqs = dec.decode_freqs(terms)
    docs, fr = collection_base[1], collection_base[2]
    for t in terms:
        assert got[t].dtype == np.uint32
        np.testing.assert_array_equal(got[t], want[t])
        np.testing.assert_array_equal(got[t], docs[t])
        np.testing.assert_array_equal(freqs[t], fr[t])
    assert not t_fi.EFTermDecoder(ti, device="cpu").device_ef


def test_term_decoder_default_device_raises_without_cuda(ef_files,
                                                         monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ti = t_fi.FreqIndexEF.load(ef_files["ef"][0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_fi.EFTermDecoder(ti, device_ef=True)


def test_ds2i_overrides_read_like_the_reference():
    """DS2I_EPS1, DS2I_EPS2 and DS2I_FIXCOST (configuration.hpp:27-35)
    change the optimal partition in both packages alike: with them set,
    each package's partitioned sequence has the same words, and they
    differ from the defaults'."""
    import subprocess
    import sys

    code = (
        "import numpy as np\n"
        "from dint_tpu.codecs import ef as j\n"
        "from dint_tpu.utils.bitio import BitBuilder as JB\n"
        "from dint_tpu_torch.codecs import ef as t\n"
        "from dint_tpu_torch.utils.bitio import BitBuilder as TB\n"
        "assert vars(j.CONF) == vars(t.CONF), (j.CONF, t.CONF)\n"
        "rng = np.random.default_rng(5)\n"
        "v = np.concatenate([\n"  # dense runs between sparse stretches
        "    np.arange(0, 3000),\n"
        "    np.sort(rng.choice(np.arange(3000, 400000), 2000, False)),\n"
        "    np.arange(400000, 406000),\n"
        "    np.sort(rng.choice(np.arange(406000, 2000000), 3000, False)),\n"
        "]).astype(np.uint64)\n"
        "out = []\n"
        "for pkg, bb in ((j, JB()), (t, TB())):\n"
        "    pkg.partitioned_sequence(pkg.indexed_sequence).write(\n"
        "        bb, v, 2000000, v.shape[0], pkg.PARAMS)\n"
        "    out.append(bb.words().tolist())\n"
        "assert out[0] == out[1]\n"
        "print(t.CONF.fix_cost, len(out[1]), hash(tuple(out[1])))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = {}
    for name, extra in (("default", {}),
                        ("set", {"DS2I_EPS1": "0.2", "DS2I_EPS2": "0.9",
                                 "DS2I_FIXCOST": "7"})):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DS2I_")}
        env.update(extra, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        got[name] = r.stdout.split()
    assert got["default"][0] == "64" and got["set"][0] == "7"
    assert got["default"][1:] != got["set"][1:]
