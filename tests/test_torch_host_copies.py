"""The port's copies of the host modules against the reference package.

Both packages synthesize, train, encode and plan the same small
collections; every artifact must be identical: the synthetic lists, the
gap transform, the statistics cache, the dictionary file, the encoded
stream and its skip sidecar, the unit layout and the serving image.
"""

import dataclasses
import os

import numpy as np
import pytest

from dint_tpu.io import collection as j_collection
from dint_tpu.io import synth as j_synth
from dint_tpu.kernels import decode_local as j_dl
from dint_tpu.tools import common as j_common
from dint_tpu.tools import decode as j_decode
from dint_tpu.tools import encode as j_encode
from dint_tpu_torch.io import collection as t_collection
from dint_tpu_torch.io import synth as t_synth
from dint_tpu_torch.kernels import decode_local as t_dl
from dint_tpu_torch.tools import common as t_common
from dint_tpu_torch.tools import decode as t_decode
from dint_tpu_torch.tools import encode as t_encode

TYPES = ("single_rect_dint", "multi_packed_dint")
DICT_KIND = {"single_rect_dint": "rectangular",
             "multi_packed_dint": "multi_packed"}


def mixed_gap_lists(seed):
    """Lists that drive all three width classes of the serving image:
    DINT-friendly gaps, exception-heavy lists (table words >= 2^16 -> the
    i32 class), and zero-run lists (all-zero tables -> the zero class)."""
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(40):
        n = int(rng.integers(20, 3000))
        r = rng.random(n)
        g = np.where(r < 0.45, 0, np.where(
            r < 0.9, rng.integers(1, 8, n), rng.integers(8, 3000, n)))
        lists.append(g.astype(np.uint32))
    for _ in range(3):
        n = int(rng.integers(50, 1200))
        g = rng.integers(0, 1 << 20, n).astype(np.uint32)
        g[rng.random(n) < 0.35] = 0
        lists.append(g)
    lists.append(np.zeros(900, np.uint32))
    lists.append(np.zeros(3000, np.uint32))
    g = np.where(rng.random(9000) < 0.7, 0, rng.integers(0, 500, 9000))
    lists.append(g.astype(np.uint32))
    return lists


def write_mixed_collection(base, seed=4):
    gaps = mixed_gap_lists(seed)
    docs = [np.cumsum(g.astype(np.int64) + 1) - 1 for g in gaps]
    num_docs = int(max(int(d[-1]) for d in docs)) + 1
    docs = [d.astype(np.uint32) for d in docs]
    freqs = [np.ones(d.shape[0], np.uint32) for d in docs]
    t_collection.write_freq_collection(base, docs, freqs, num_docs)
    return gaps


def encode_both(root, base, type_name):
    """Encode ``base.docs`` with each package into its own directory;
    return {pkg: (stream path, dict path)}."""
    out = {}
    for pkg, enc in (("jax", j_encode), ("torch", t_encode)):
        d = os.path.join(root, pkg)
        os.makedirs(d, exist_ok=True)
        stream = os.path.join(d, f"s.{type_name}.bin")
        enc.encode_collection(type_name, base + ".docs", stream, cache_dir=d)
        dict_file = os.path.join(
            d, f"dict.{os.path.basename(base)}.docs."
               f"{DICT_KIND[type_name]}.DSF-65536-16")
        out[pkg] = (stream, dict_file)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_host"))
    base = os.path.join(root, "mixed")
    gaps = write_mixed_collection(base)
    enc = {t: encode_both(os.path.join(root, t), base, t) for t in TYPES}
    return root, base, gaps, enc


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_synth_collection_identical():
    jd, jf = j_synth.make_collection(50, 4000, seed=11, avg_len=60)
    td, tf = t_synth.make_collection(50, 4000, seed=11, avg_len=60)
    assert len(jd) == len(td)
    for a, b in zip(jd + jf, td + tf):
        np.testing.assert_array_equal(a, b)


def test_collection_files_and_gaps_identical(tmp_path):
    docs, freqs = t_synth.make_collection(30, 3000, seed=3, avg_len=40)
    j_collection.write_freq_collection(str(tmp_path / "j"), docs, freqs, 3000)
    t_collection.write_freq_collection(str(tmp_path / "t"), docs, freqs, 3000)
    for ext in (".docs", ".freqs"):
        assert _bytes(tmp_path / ("j" + ext)) == _bytes(tmp_path / ("t" + ext))
    jg, jn = j_common.gap_lists_of(str(tmp_path / "j.docs"))
    tg, tn = t_common.gap_lists_of(str(tmp_path / "t.docs"))
    assert jn == tn and len(jg) == len(tg)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("type_name", TYPES)
def test_dictionary_file_identical(corpus, type_name):
    _, _, _, enc = corpus
    (_, jdict), (_, tdict) = enc[type_name]["jax"], enc[type_name]["torch"]
    assert _bytes(jdict) == _bytes(tdict)


@pytest.mark.parametrize("type_name", TYPES)
def test_statistics_cache_identical(corpus, type_name):
    _, _, _, enc = corpus
    jdir = os.path.dirname(enc[type_name]["jax"][0])
    tdir = os.path.dirname(enc[type_name]["torch"][0])
    names = sorted(f for f in os.listdir(jdir) if "statistics" in f)
    assert names and names == sorted(
        f for f in os.listdir(tdir) if "statistics" in f)
    for f in names:
        assert _bytes(os.path.join(jdir, f)) == _bytes(os.path.join(tdir, f))


@pytest.mark.parametrize("type_name", TYPES)
def test_stream_and_sidecar_identical(corpus, type_name):
    _, _, _, enc = corpus
    js, ts = enc[type_name]["jax"][0], enc[type_name]["torch"][0]
    assert _bytes(js) == _bytes(ts)
    jside = sorted(f for f in os.listdir(os.path.dirname(js))
                   if f.startswith(os.path.basename(js)))
    tside = sorted(f for f in os.listdir(os.path.dirname(ts))
                   if f.startswith(os.path.basename(ts)))
    assert jside == tside and len(jside) >= 2
    for f in jside:
        assert _bytes(os.path.join(os.path.dirname(js), f)) == _bytes(
            os.path.join(os.path.dirname(ts), f)), f


def _layouts(enc, type_name):
    from dint_tpu.index import stream as j_stream
    from dint_tpu_torch.index import stream as t_stream

    multi = type_name.startswith("multi")
    stream = enc[type_name]["torch"][0]
    ja, jm = j_stream.load_stream(stream)
    ta, tm = t_stream.load_stream(stream)
    np.testing.assert_array_equal(ja, ta)
    return (ja, jm, j_decode.units_from_meta(ja, jm, multi),
            ta, tm, t_decode.units_from_meta(ta, tm, multi))


@pytest.mark.parametrize("type_name", TYPES)
def test_unit_layout_identical(corpus, type_name):
    _, _, _, enc = corpus
    _, _, jl, _, _, tl = _layouts(enc, type_name)
    for f in dataclasses.fields(jl):
        np.testing.assert_array_equal(getattr(jl, f.name),
                                      getattr(tl, f.name), err_msg=f.name)


@pytest.mark.parametrize("type_name", TYPES)
def test_plan_stream_image_identical(corpus, type_name):
    _, _, _, enc = corpus
    ja, _, jl, ta, _, tl = _layouts(enc, type_name)
    dict_file = enc[type_name]["torch"][1]
    jv = j_decode.load_dictionary(type_name, dict_file).decode_view()
    tv = t_decode.load_dictionary(type_name, dict_file).decode_view()
    for f in ("table", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(jv, f), getattr(tv, f))
    jimg = j_dl.plan_stream_image(ja, jl.starts, jl.byte_lens, jl.n, jl.ctx,
                                  jl.b_bits, jv)
    timg = t_dl.plan_stream_image(ta, tl.starts, tl.byte_lens, tl.n, tl.ctx,
                                  tl.b_bits, tv)
    for f in dataclasses.fields(jimg):
        a, b = getattr(jimg, f.name), getattr(timg, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert timg.device_bytes() == jimg.device_bytes()
    assert timg.total_ints() == jimg.total_ints()
    # the mixed collection drives every width class
    assert min(timg.n0.shape[0], timg.n16.shape[0], timg.n32.shape[0]) > 0
