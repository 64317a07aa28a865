"""The port's statistics merge and collectors against the reference.

``stats/device_merge.unique_weighted_device`` runs as torch ops (here on
the CPU) and is held to the reference's ``force=True`` merge (JAX on the
CPU) as a set of (window, count) pairs: the two sort the windows in
different orders, which the statistics do not see.  The sizes are 1-16
columns, one input above ``CHUNK`` rows that takes the tree merge, and
windows with bit 31 set.  The gates (the int32 guards, the 9/10 rule,
the row count) return ``None`` where the reference's do.  The
collectors and ``compute_stats``'s collectors branch (the native
collector forced to return ``None``) equal the reference's, with the
merges in numpy and with every merge sent to the device path.
"""

import numpy as np
import pytest
import torch

from dint_tpu.io import collection as j_coll
from dint_tpu.stats import block_stats as j_bs
from dint_tpu.stats import collectors as j_col
from dint_tpu.stats import device_merge as j_dm
from dint_tpu.stats import native_stats as j_ns
from dint_tpu_torch.io import collection as t_coll
from dint_tpu_torch.io import synth
from dint_tpu_torch.stats import block_stats as t_bs
from dint_tpu_torch.stats import collectors as t_col
from dint_tpu_torch.stats import device_merge as t_dm
from dint_tpu_torch.stats import native_stats as t_ns

I32 = np.iinfo(np.int32).max


def as_set(got):
    windows, counts = got
    assert windows.dtype == np.uint32 and windows.shape[0] == counts.shape[0]
    d = {tuple(r): int(c) for r, c in zip(windows.tolist(), counts.tolist())}
    assert len(d) == windows.shape[0]  # no window twice
    return d


def windows(n: int, s: int, alphabet: int, seed: int):
    """n windows of s u32 values from a small alphabet (many repeats),
    every fifth value with bit 31 set; weights 1-4."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, alphabet, (n, s)).astype(np.uint32)
    w[::5, 0] |= np.uint32(0x80000000)
    return w, rng.integers(1, 5, n).astype(np.int64)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 8, 15, 16])
def test_merge_equals_reference_as_sets(s):
    w, wt = windows(3000, s, 3 if s > 4 else 40, seed=s)
    got = t_dm.unique_weighted_device(w, wt, force=True, device="cpu")
    want = j_dm.unique_weighted_device(w, wt, force=True)
    assert as_set(got) == as_set(want)
    assert sum(as_set(got).values()) == int(wt.sum())


def test_merge_above_chunk_takes_the_tree_merge():
    w, wt = windows(t_dm.CHUNK + 5000, 1, 300, seed=1)
    t_dm.reset_merge_counts()
    got = t_dm.unique_weighted_device(w, wt, force=True, device="cpu")
    counts = t_dm.merge_counts()
    # two chunks, then one merge of what they left
    assert counts["merges"] == 1 and counts["chunks"] == 3
    assert w.shape[0] < counts["rows"] <= w.shape[0] + 2 * 600
    assert as_set(got) == as_set(j_dm.unique_weighted_device(w, wt,
                                                             force=True))


def test_merge_drops_rows_of_weight_zero():
    w = np.array([[1], [2], [1], [3]], np.uint32)
    wt = np.array([0, 2, 0, 1], np.int64)
    got = t_dm.unique_weighted_device(w, wt, force=True, device="cpu")
    assert as_set(got) == {(2,): 2, (3,): 1}
    assert as_set(got) == as_set(j_dm.unique_weighted_device(w, wt,
                                                             force=True))


@pytest.mark.parametrize("case", ["max", "sum"])
def test_int32_guards_return_none_as_the_reference(case):
    w, wt = windows(64, 4, 5, seed=3)
    if case == "max":
        wt[7] = I32 // 2 + 1
    else:
        wt[:] = I32 // 2 // 32
    assert t_dm.unique_weighted_device(w, wt, force=True, device="cpu") is None
    assert j_dm.unique_weighted_device(w, wt, force=True) is None
    wt[:] = 1
    assert t_dm.unique_weighted_device(w, wt, force=True,
                                       device="cpu") is not None


def test_nine_tenths_rule_returns_none_as_the_reference(monkeypatch):
    """Above CHUNK rows a round that keeps more than 9/10 of its rows
    gives the merge back to numpy, in both packages (CHUNK cut to 64
    here so that distinct windows are cheap)."""
    monkeypatch.setattr(t_dm, "CHUNK", 64)
    monkeypatch.setattr(j_dm, "CHUNK", 64)
    rng = np.random.default_rng(4)
    distinct = rng.permutation(1000)[:300].astype(np.uint32)[:, None]
    wt = np.ones(300, np.int64)
    assert t_dm.unique_weighted_device(distinct, wt, force=True,
                                       device="cpu") is None
    assert j_dm.unique_weighted_device(distinct, wt, force=True) is None
    # repeats dedup well: the tree merge finishes on the device
    rep, wt2 = windows(300, 2, 4, seed=5)
    assert as_set(t_dm.unique_weighted_device(rep, wt2, force=True,
                                              device="cpu")) == as_set(
        j_dm.unique_weighted_device(rep, wt2, force=True))


def test_small_merges_stay_in_numpy():
    w, wt = windows(100, 2, 5, seed=6)
    assert t_dm.unique_weighted_device(w, wt, device="cpu") is None


def test_a_card_asked_for_and_missing_raises():
    """WindowCounter and the collectors default to the card; without
    one they raise instead of merging on the CPU."""
    if torch.cuda.is_available():
        assert t_col.WindowCounter(4).device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        t_col.WindowCounter(4)
    with pytest.raises(RuntimeError):
        t_col.collect_single([np.arange(32, dtype=np.uint32)])


def test_device_merge_errors_raise(monkeypatch):
    """The reference prints a device-merge error and merges in numpy;
    the port lets it raise."""
    def broken(cols, weights):
        raise ValueError("device merge failed")

    monkeypatch.setattr(t_dm, "MIN_DEVICE_ROWS", 0)
    monkeypatch.setattr(t_dm, "_merge_fn", broken)
    c = t_col.WindowCounter(2, device="cpu")
    c.add(np.zeros((8, 2), np.uint32))
    with pytest.raises(ValueError, match="device merge failed"):
        c.finalize()


def gap_lists(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(30):
        n = int(rng.integers(1, 900))
        g = np.where(rng.random(n) < 0.4, 0,
                     rng.integers(1, 300, n)).astype(np.uint32)
        if i % 7 == 0:
            g[::11] = rng.integers(1 << 16, 1 << 31, g[::11].shape[0])
        out.append(g)
    return out


def assert_collected_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert as_set(got[key]) == as_set(want[key]), key


@pytest.mark.parametrize("device_merges", [False, True],
                         ids=["numpy_merges", "device_merges"])
def test_collectors_equal_reference(monkeypatch, device_merges):
    if device_merges:
        monkeypatch.setattr(t_dm, "MIN_DEVICE_ROWS", 0)
    t_dm.reset_merge_counts()
    lists = gap_lists(7)
    assert_collected_equal(t_col.collect_single(lists, device="cpu"),
                           j_col.collect_single(lists))
    assert_collected_equal(t_col.collect_multi(lists, device="cpu"),
                           j_col.collect_multi(lists))
    assert (t_dm.merge_counts()["merges"] > 0) == device_merges


def test_window_counter_periodic_merges(monkeypatch):
    monkeypatch.setattr(t_dm, "MIN_DEVICE_ROWS", 0)
    tc = t_col.WindowCounter(4, merge_threshold=50, device="cpu")
    jc = j_col.WindowCounter(4, merge_threshold=50)
    for seed in range(6):
        w, wt = windows(40, 4, 3, seed)
        tc.add(w, wt)
        jc.add(w, wt)
    assert as_set(tc.finalize()) == as_set(jc.finalize())


def test_selectors_and_ceil_log2_equal_reference():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 40, 500, dtype=np.uint64)
    np.testing.assert_array_equal(t_col.ceil_log2(x), j_col.ceil_log2(x))
    for v in (0, 1, 2, 3, 255, 256, 257, 1 << 31):
        assert t_col.ceil_log2_int(v) == j_col.ceil_log2_int(v)
    blocks = rng.integers(0, 1 << 20, (40, 256)).astype(np.uint32)
    blocks[::3] &= np.uint32(0xF)
    np.testing.assert_array_equal(t_col.selectors_for_blocks(blocks),
                                  j_col.selectors_for_blocks(blocks))


@pytest.fixture(scope="module")
def stats_collection(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("stats") / "c")
    docs, freqs = synth.make_collection(40, 30000, seed=21, avg_len=700)
    t_coll.write_freq_collection(base, docs, freqs, 30000)
    return base


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("gaps", [True, False], ids=["docs", "freqs"])
@pytest.mark.parametrize("device_merges", [False, True],
                         ids=["numpy_merges", "device_merges"])
def test_compute_stats_collectors_branch(monkeypatch, stats_collection,
                                         multi, gaps, device_merges):
    """With the native collector returning None both packages count
    through their collectors: the same contexts, record for record."""
    monkeypatch.setattr(t_ns, "compute_stats_native", lambda *a, **k: None)
    monkeypatch.setattr(j_ns, "compute_stats_native", lambda *a, **k: None)
    if device_merges:
        monkeypatch.setattr(t_dm, "MIN_DEVICE_ROWS", 0)
    path = stats_collection + (".docs" if gaps else ".freqs")
    got = t_bs.compute_stats(t_coll.BinaryCollection(path), gaps, multi,
                             device="cpu")
    want = j_bs.compute_stats(j_coll.BinaryCollection(path), gaps, multi)
    assert got.total_integers == want.total_integers
    assert len(got.contexts) == len(want.contexts)
    for g, w in zip(got.contexts, want.contexts):
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.freqs, w.freqs)
        np.testing.assert_array_equal(g.data, w.data)
    assert sum(c.lengths.shape[0] for c in got.contexts) > 0
