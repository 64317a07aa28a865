"""The port's batch encoder against the reference's.

The reference fixture of tests/test_batch_encode_decode.py (60 gap
lists, mean length 500; a single and a multi dictionary trained by the
reference, stored, and loaded by each package).  Every numpy coder of
the port's ``codecs/encode_batch`` must give the reference's arrays and
bytes; ``encode_single_lists`` / ``encode_multi_lists`` must write the
reference's numpy bytes through both ``prefer_native=False`` (numpy)
and ``prefer_native=True`` (the native encoder); a 30,000-int list
parsed in chunks must round-trip; ``DS2I_HEURISTIC_GREEDY=1`` must give
the reference's greedy bytes.
"""

import numpy as np
import pytest

from dint_tpu.codecs import dint as j_dint
from dint_tpu.codecs import encode_batch as j_eb
from dint_tpu.config import NUM_SELECTORS
from dint_tpu.dictionary.builder import build_dictionary
from dint_tpu.stats import block_stats, collectors
from dint_tpu_torch.codecs import dint as t_dint
from dint_tpu_torch.codecs import encode_batch as t_eb
from dint_tpu_torch.codecs import native as t_native
from dint_tpu_torch.dictionary.dictionary import (
    MultiPackedDictionary,
    PackedDictionary,
)
from tests.test_dictionary_and_dint import make_gap_lists


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(gap lists, {"ref": (single, multi), "port": (single, multi)})."""
    gap_lists = make_gap_lists(np.random.default_rng(7), num=60, mean_len=500)
    total = sum(len(g) for g in gap_lists)
    per_size = collectors.collect_single(gap_lists)
    sstats = block_stats.BlockStats(
        total, [block_stats._filter_sort(per_size, total)])
    per_key = collectors.collect_multi(gap_lists)
    mstats = block_stats.BlockStats(total, [
        block_stats._filter_sort(
            {s: per_key[(sel, s)] for s in collectors.TARGET_SIZES}, total)
        for sel in range(NUM_SELECTORS)
    ])
    ds = build_dictionary(sstats, "single")
    dm = build_dictionary(mstats, "multi")
    tmp = tmp_path_factory.mktemp("torch_encode_batch")
    ds.store(str(tmp / "single.dict"))
    dm.store(str(tmp / "multi.dict"))
    port = (PackedDictionary.load(str(tmp / "single.dict")),
            MultiPackedDictionary.load(str(tmp / "multi.dict")))
    return gap_lists, {"ref": (ds, dm), "port": port}


def _lookups(dicts, pkg, multi, sel=0):
    d = dicts[pkg][1 if multi else 0]
    return d.lookup_tables()[0][sel] if multi else d.lookup_table()


def _batch(gap_lists, L=512, count=12):
    units = [g[:L] for g in gap_lists[:count]]
    gaps, n = j_eb.pad_units(units, L)
    return units, gaps, n


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("stage", ["pad_units", "zero_run_lengths",
                                   "precompute_hits", "hits8_from_hits16",
                                   "opt_parse_batch", "extract_paths",
                                   "path_token_counts", "emit_unit"])
def test_numpy_coder_stage_matches_reference(setup, stage, multi):
    """Each stage of the batched parse, fed the same inputs, returns the
    reference's arrays (the b=8 stages under the multi dictionary's
    first selector), and ``emit_unit`` its bytes."""
    gap_lists, dicts = setup
    units, gaps, n = _batch(gap_lists)
    out = {}
    for pkg, eb in (("ref", j_eb), ("port", t_eb)):
        lt = _lookups(dicts, pkg, multi)
        if stage == "pad_units":
            out[pkg] = eb.pad_units(units, 512)
            continue
        if stage == "zero_run_lengths":
            out[pkg] = (eb.zero_run_lengths(gaps, n),)
            continue
        hits = eb.precompute_hits(lt, gaps, n)
        if stage == "precompute_hits":
            out[pkg] = tuple(hits[s] for s in sorted(hits))
            continue
        if multi:
            hits = eb.hits8_from_hits16(hits)
        if stage == "hits8_from_hits16":
            out[pkg] = tuple(hits[s] for s in sorted(hits))
            continue
        parent, codeword, cost = eb.opt_parse_batch(hits, gaps, n)
        if stage == "opt_parse_batch":
            out[pkg] = (parent, codeword, cost)
            continue
        visited = eb.extract_paths(parent, n)
        if stage == "extract_paths":
            out[pkg] = (visited,)
            continue
        b = 8 if multi else 16
        if stage == "path_token_counts":
            out[pkg] = (eb.path_token_counts(visited, codeword, b),)
            continue
        out[pkg] = tuple(
            np.frombuffer(eb.emit_unit(visited[j], codeword[j], gaps[j], b),
                          np.uint8) for j in range(gaps.shape[0]))
    assert len(out["ref"]) == len(out["port"])
    for a, b in zip(out["ref"], out["port"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _zero_run_lists():
    """Lists with zero runs of every run codeword's reach (16 to 256 and
    past it) between short stretches of small gaps."""
    rng = np.random.default_rng(11)
    out = []
    for runs in ((20, 70, 140), (300, 17, 33), (260, 129, 65, 16)):
        parts = []
        for r in runs:
            parts += [rng.integers(1, 6, 9), np.zeros(r, np.int64)]
        out.append(np.concatenate(parts + [rng.integers(1, 6, 5)])
                   .astype(np.uint32))
    return out


@pytest.mark.parametrize("coder", ["encode_opt_units", "encode_opt_list",
                                   "encode_opt_lists",
                                   "encode_multi_opt_lists"])
def test_numpy_coder_bytes_match_reference(setup, coder):
    gap_lists, dicts = setup
    lists = ([g for g in gap_lists if len(g) <= t_eb.OPT_CHUNK][:25]
             + _zero_run_lists())
    got = {}
    for pkg, eb in (("ref", j_eb), ("port", t_eb)):
        lt = _lookups(dicts, pkg, False)
        if coder == "encode_opt_units":
            got[pkg] = eb.encode_opt_units(lt, lists, 16)
        elif coder == "encode_opt_list":
            got[pkg] = [eb.encode_opt_list(lt, g) for g in lists[:8]]
        elif coder == "encode_opt_lists":
            got[pkg] = eb.encode_opt_lists(lt, lists)
        else:
            got[pkg] = eb.encode_multi_opt_lists(
                dicts[pkg][1], gap_lists[:20] + _zero_run_lists())
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("prefer_native", [False, True])
def test_encode_lists_match_reference(setup, multi, prefer_native):
    """Both routes of the port write the reference's numpy bytes and
    unit lengths (and the scalar oracle's for the multi parse)."""
    gap_lists, dicts = setup
    lists = gap_lists[:20] if multi else gap_lists
    if multi:
        want = j_eb.encode_multi_opt_lists(dicts["ref"][1], lists)
        got = t_eb.encode_multi_lists(dicts["port"][1], lists,
                                      prefer_native=prefer_native)
        lt16, lt8 = dicts["ref"][1].lookup_tables()
        for g, s in zip(lists, got[0]):
            assert s == j_dint.encode_multi_opt(lt16, lt8, g)
    else:
        want = j_eb.encode_single_lists(dicts["ref"][0], lists,
                                        prefer_native=False)
        got = t_eb.encode_single_lists(dicts["port"][0], lists,
                                       prefer_native=prefer_native)
    assert got == want


def test_single_lists_match_the_scalar_oracle(setup):
    gap_lists, dicts = setup
    lt = dicts["ref"][0].lookup_table()
    lists = [g for g in gap_lists if len(g) <= t_eb.OPT_CHUNK][:30]
    streams, _ = t_eb.encode_single_lists(dicts["port"][0], lists,
                                          prefer_native=False)
    for g, got in zip(lists, streams):
        assert got == j_dint.encode_opt_single(lt, g)


@pytest.mark.parametrize("prefer_native", [False, True])
def test_long_list_chunked_roundtrip(setup, prefer_native):
    """A 30,000-int list, parsed in OPT_CHUNK units, decodes back."""
    _, dicts = setup
    ds = dicts["port"][0]
    view = ds.decode_view()
    rng = np.random.default_rng(1)
    g = np.where(rng.random(30000) < 0.5, 0,
                 rng.integers(0, 2000, 30000)).astype(np.uint32)
    if prefer_native:
        (buf,), (lens,) = t_eb.encode_single_lists(ds, [g],
                                                   prefer_native=True)
        assert len(lens) == -(-30000 // t_eb.OPT_CHUNK)
    else:
        buf = t_eb.encode_opt_list(ds.lookup_table(), g)
    assert buf == j_eb.encode_opt_list(dicts["ref"][0].lookup_table(), g)
    out = np.zeros(len(g), np.uint32)
    end = t_dint.decode_single(view, buf, 0, len(g), out)
    assert end == len(buf)
    np.testing.assert_array_equal(out, g)


@pytest.mark.parametrize("prefer_native", [False, True])
def test_heuristic_greedy_env_switch(setup, monkeypatch, prefer_native):
    """DS2I_HEURISTIC_GREEDY=1 gives the reference's greedy bytes, which
    decode to the same ints."""
    gap_lists, dicts = setup
    lists = [g for g in gap_lists if 0 < len(g) <= 1500][:6]
    opt, _ = t_eb.encode_single_lists(dicts["port"][0], lists,
                                      prefer_native=prefer_native)
    monkeypatch.setenv("DS2I_HEURISTIC_GREEDY", "1")
    got = t_eb.encode_single_lists(dicts["port"][0], lists,
                                   prefer_native=prefer_native)
    want = j_eb.encode_single_lists(dicts["ref"][0], lists,
                                    prefer_native=prefer_native)
    assert got == want
    view = dicts["port"][0].decode_view()
    lt = dicts["ref"][0].lookup_table()
    for g, ob, gb in zip(lists, opt, got[0]):
        assert len(gb) >= len(ob)
        assert gb == j_dint.encode_greedy_single(lt, g)
        out = np.zeros(len(g), np.uint32)
        t_dint.decode_single(view, np.frombuffer(gb, np.uint8), 0, len(g),
                             out, 0, 16, 0)
        np.testing.assert_array_equal(out, g)


@pytest.mark.parametrize("multi", [False, True])
def test_prefer_native_raises_without_the_library(setup, monkeypatch, multi):
    """prefer_native=True never falls back to numpy: without the native
    encoder it raises; prefer_native=False still encodes."""
    gap_lists, dicts = setup
    d = dicts["port"][1 if multi else 0]
    fn = t_eb.encode_multi_lists if multi else t_eb.encode_single_lists
    monkeypatch.setattr(t_native, "native_encoder_for", lambda d: None)
    with pytest.raises(RuntimeError, match="native DINT encoder"):
        fn(d, gap_lists[:3])
    streams, _ = fn(d, gap_lists[:3], prefer_native=False)
    assert len(streams) == 3 and all(streams)
