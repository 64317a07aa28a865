"""The port's sharded steps against the reference's under shard_map.

Every step of ``dint_tpu_torch/parallel/steps.py`` runs on S gloo ranks
of the CPU (``dist.run_ranks``, spawned once per S for the whole module)
and the reference's on a mesh of the same S virtual CPU devices, for
S = 1 and S = 4, on the inputs of ``tests/test_parallel_steps.py`` and
of the dry run.  Integers are held exact (hashes, selectors and the
statistics histogram with lanes that have bit 31 set, the AND masks, the
ladder decode); top-k scores within rtol 1e-6, their docids as sets; the
rows steps' scores within rtol 1e-5 (the reference's sort is not
stable, so equal docids may add in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dint_tpu.parallel import steps as j_steps
from dint_tpu_torch.parallel import dist as pdist
from dint_tpu_torch.parallel import steps as t_steps
from dint_tpu_torch.query import device_batch as t_db
from tests import torch_ranks

K = 10
N_BUCKETS = 1 << 10
PAD = int(t_db.PAD_DOC)
WORLDS = (1, 4)


def _t(a):
    return pdist.to_tensors(np.asarray(a), "cpu")


def stats_blocks(seed: int, high: bool) -> np.ndarray:
    """64 gap blocks: values below 1000 (tests/test_parallel_steps.py),
    or any u32 with bit 31 set in every 7th lane."""
    rng = np.random.default_rng(seed)
    if not high:
        return rng.integers(0, 1000, (64, 256)).astype(np.uint32)
    b = rng.integers(0, 2**32, (64, 256), dtype=np.uint64).astype(np.uint32)
    b[:, ::7] |= np.uint32(0x80000000)
    b[:8] &= np.uint32(0xFF)  # a few low selector contexts too
    return b


def and_case(S: int, seed: int = 1):
    """tests/test_parallel_steps.py's AND inputs with one term list a
    rank: (cand, lists (S, Q, L), valid (S, Q), expect (Q, C))."""
    rng = np.random.default_rng(seed)
    Q, C, L = 4, 16, 32
    cand = np.sort(rng.choice(500, (Q, C), replace=False)).astype(np.uint32)
    lists = np.full((S, Q, L), 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros((S, Q), dtype=bool)
    expect = np.ones((Q, C), dtype=bool)
    for d in range(S):
        for q in range(Q):
            if rng.random() < 0.8:
                members = rng.choice(cand[q], size=rng.integers(1, C),
                                     replace=False)
                extra = rng.choice(500, size=5)
                lst = np.unique(np.concatenate([members, extra]))[:L]
                lists[d, q, : lst.shape[0]] = np.sort(lst)
                valid[d, q] = True
                expect[q] &= np.isin(cand[q], lst)
    return cand, lists, valid, expect


def doc_rows(S: int, seed: int, Q: int = 5, P: int = 64, span: int = 300):
    """(S, Q, P) int32 docids in each shard's doc range with repeats (a
    docid of several terms) and PAD padding, a short row of fewer than K
    postings, and float32 partial scores."""
    rng = np.random.default_rng(seed)
    d = np.full((S, Q, P), PAD, np.int32)
    s = np.zeros((S, Q, P), np.float32)
    for j in range(S):
        for q in range(Q):
            n = 4 if q == 0 else int(rng.integers(P // 2, P + 1))
            d[j, q, :n] = rng.integers(j * span, j * span + 40, n)
            s[j, q, :n] = rng.random(n).astype(np.float32) * 3
    return d, s


def term_rows(S: int, seed: int, Q: int = 4, P: int = 32, span: int = 300):
    """(S src, S dest, Q, P): source shard j's rows bucketed by the doc
    range of their destination."""
    rng = np.random.default_rng(seed)
    d = np.full((S, S, Q, P), PAD, np.int32)
    s = np.zeros((S, S, Q, P), np.float32)
    for j in range(S):
        for dj in range(S):
            for q in range(Q):
                n = int(rng.integers(0, P + 1))
                d[j, dj, q, :n] = rng.integers(dj * span, dj * span + 50, n)
                s[j, dj, q, :n] = rng.random(n).astype(np.float32)
    return d, s


def ladder_values() -> np.ndarray:
    """A stream of 40 full blocks and a tail, each block at its own
    width, one of them 32 bits wide with bit 31 set."""
    rng = np.random.default_rng(5)
    parts = []
    for i in range(40):
        w = (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 20, 31, 32)[i % 14]
        parts.append(rng.integers(0, 2**w, 256, dtype=np.uint64))
    parts.append(rng.integers(0, 100, 77, dtype=np.uint64))
    flat = np.concatenate(parts).astype(np.uint32)
    flat[13 * 256] = 0xFFFFFFFF
    return flat


def shards(a: np.ndarray, S: int):
    """Split the leading axis into S contiguous rank slices."""
    per = a.shape[0] // S
    return [a[r * per:(r + 1) * per] for r in range(S)]


def make_cases(S: int):
    """{name: (step, per-rank args, kwargs)} for ``steps_body``."""
    cases = {}
    for name, high in (("stats_low", False), ("stats_high", True)):
        b = stats_blocks(0, high)
        cases[name] = ("stats_training_step",
                       [(x,) for x in shards(b, S)], {"n_buckets": N_BUCKETS})
    cand, lists, valid, _ = and_case(S)
    cases["and"] = ("term_sharded_and_step",
                    [(cand, lists[r], valid[r]) for r in range(S)], {})
    parts = np.random.default_rng(2).random((S, 5, 64)).astype(np.float32)
    cases["term_topk"] = ("term_sharded_topk_step",
                          [(parts[r], K) for r in range(S)], {})
    docs = np.stack([np.arange(s * 64, (s + 1) * 64, dtype=np.int32)[None]
                     .repeat(5, 0) for s in range(S)])
    scores = np.random.default_rng(3).random((S, 5, 64)).astype(np.float32)
    cases["doc_topk"] = ("doc_sharded_topk_step",
                         [(docs[r], scores[r], K) for r in range(S)], {})
    d, s = doc_rows(S, 4)
    cases["doc_rows"] = ("doc_sharded_rows_topk_step",
                         [(d[r], s[r], K) for r in range(S)], {})
    td, ts = term_rows(S, 6)
    cases["term_rows"] = ("term_sharded_rows_topk_step",
                          [(td[r], ts[r], K) for r in range(S)], {})
    packed, counts, _, _ = t_steps.ladder_shard_pack(ladder_values(), S)
    cases["ladder"] = ("ladder_sharded_decode_step",
                       [({w: a[r] for w, a in packed.items()},
                         {w: c[r] for w, c in counts.items()})
                        for r in range(S)], {})
    return cases


@pytest.fixture(scope="module", params=WORLDS, ids=lambda S: f"S{S}")
def world(request):
    """(S, the port's results a rank, the reference's mesh of S devices):
    the ranks spawn once per S for every test of the module."""
    S = request.param
    res = pdist.run_ranks(torch_ranks.steps_body, S, "cpu",
                          (make_cases(S),), timeout_s=240)
    devs = np.array(jax.devices()[:S])
    assert devs.size == S
    return S, res, Mesh(devs, ("dp",))


def _smap(fn, mesh, in_specs, out_specs):
    return j_steps.make_shard_map(fn, mesh, in_specs, out_specs)


def _same_on_every_rank(res, name):
    for r in res[1:]:
        for a, b in zip(res[0][name], r[name]):
            np.testing.assert_array_equal(a, b)
    return res[0][name]


# ---------------------------------------------------------------------------
# Hashes and selectors (rank-local)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("high", [False, True], ids=["low", "bit31"])
def test_mix32_hashes_selectors_exact(high):
    b = stats_blocks(0, high)
    jb = jnp.asarray(b)
    np.testing.assert_array_equal(
        t_steps.mix32(_t(b)).numpy(),
        np.asarray(j_steps.mix32(jb)).astype(np.int64))
    for s in (16, 8, 4, 2, 1):
        np.testing.assert_array_equal(
            t_steps.window_bucket_hashes(_t(b), s).numpy(),
            np.asarray(j_steps.window_bucket_hashes(jb, s)).astype(np.int64))
    np.testing.assert_array_equal(t_steps.selectors(_t(b)).numpy(),
                                  np.asarray(j_steps.selectors(jb)))


def test_selectors_take_the_unsigned_max():
    """An int32 max of u32 data would pick 5 over 0x80000000."""
    b = np.zeros((2, 256), np.uint32)
    b[0, 0], b[0, 1] = 5, 0x80000000
    b[1, 3] = 3
    np.testing.assert_array_equal(t_steps.selectors(_t(b)).numpy(), [5, 1])


def test_seg_scan_matches_seg_scan_rows():
    """steps reuses device_batch._seg_scan for the reference's
    _seg_scan_rows: the same recurrence, the same sums bit for bit."""
    rng = np.random.default_rng(9)
    x = rng.random((3, 64)).astype(np.float32)
    start = rng.random((3, 64)) < 0.3
    start[:, 0] = True
    np.testing.assert_array_equal(
        t_db._seg_scan(_t(x), _t(start)).numpy(),
        np.asarray(j_steps._seg_scan_rows(jnp.asarray(x), jnp.asarray(start))))


# ---------------------------------------------------------------------------
# Collective steps, S ranks against a mesh of S devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,high", [("stats_low", False),
                                       ("stats_high", True)])
def test_stats_training_step(world, name, high):
    S, res, mesh = world
    b = stats_blocks(0, high)
    counts, sel = jax.jit(j_steps.stats_training_step,
                          static_argnames=("n_buckets",))(
        jax.device_put(jnp.asarray(b), NamedSharding(mesh, P("dp", None))),
        n_buckets=N_BUCKETS)
    for r in res:
        np.testing.assert_array_equal(r[name][0], np.asarray(counts))
    np.testing.assert_array_equal(
        np.concatenate([r[name][1] for r in res]), np.asarray(sel))
    assert int(res[0][name][0].sum()) == 64 * sum(256 // s for s in
                                                  (16, 8, 4, 2, 1))


def test_term_sharded_and(world):
    S, res, mesh = world
    cand, lists, valid, expect = and_case(S)
    fn = _smap(lambda c, sd, sv: j_steps.term_sharded_and_step(c, sd[0], sv[0]),
               mesh, (P(), P("dp", None, None), P("dp", None)), P())
    want = np.asarray(fn(jnp.asarray(cand), jnp.asarray(lists),
                         jnp.asarray(valid)))
    np.testing.assert_array_equal(want, expect)
    for r in res:
        np.testing.assert_array_equal(r["and"], want)


def _topk_close(got_v, got_i, want_v, want_i, rtol):
    np.testing.assert_allclose(got_v, want_v, rtol=rtol)
    for gi, wi in zip(got_i, want_i):
        assert set(gi.tolist()) == set(wi.tolist())


def test_term_sharded_topk(world):
    S, res, mesh = world
    parts = np.random.default_rng(2).random((S, 5, 64)).astype(np.float32)
    fn = _smap(lambda sc: j_steps.term_sharded_topk_step(sc[0], K), mesh,
               (P("dp", None, None),), P())
    v, ids = fn(jnp.asarray(parts))
    got = _same_on_every_rank(res, "term_topk")
    _topk_close(*got, np.asarray(v), np.asarray(ids), 1e-6)


def test_doc_sharded_topk(world):
    S, res, mesh = world
    docs = np.stack([np.arange(s * 64, (s + 1) * 64, dtype=np.int32)[None]
                     .repeat(5, 0) for s in range(S)])
    scores = np.random.default_rng(3).random((S, 5, 64)).astype(np.float32)
    fn = _smap(lambda d, s: j_steps.doc_sharded_topk_step(d[0], s[0], K),
               mesh, (P("dp", None, None), P("dp", None, None)), P())
    v, ids = fn(jnp.asarray(docs), jnp.asarray(scores))
    got = _same_on_every_rank(res, "doc_topk")
    _topk_close(*got, np.asarray(v), np.asarray(ids), 1e-6)


def _rows_close(got, v, ids):
    """Finite scores within rtol 1e-5 and their docids as sets; the
    -inf slots of a row with fewer than K documents carry no docid."""
    gv, gi = got
    v, ids = np.asarray(v), np.asarray(ids)
    fin = np.isfinite(v)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], v[fin], rtol=1e-5)
    for q in range(v.shape[0]):
        assert set(gi[q][fin[q]].tolist()) == set(ids[q][fin[q]].tolist())


def test_doc_sharded_rows_topk(world):
    S, res, mesh = world
    d, s = doc_rows(S, 4)
    fn = _smap(lambda d, s: j_steps.doc_sharded_rows_topk_step(d[0], s[0], K),
               mesh, (P("dp", None, None), P("dp", None, None)), P())
    v, ids = fn(jnp.asarray(d), jnp.asarray(s))
    _rows_close(_same_on_every_rank(res, "doc_rows"), v, ids)


def test_term_sharded_rows_topk(world):
    S, res, mesh = world
    d, s = term_rows(S, 6)
    spec = P("dp", None, None, None)
    fn = _smap(lambda d, s: j_steps.term_sharded_rows_topk_step(d, s, K),
               mesh, (spec, spec), P())
    v, ids = fn(jnp.asarray(d), jnp.asarray(s))
    _rows_close(_same_on_every_rank(res, "term_rows"), v, ids)


def test_ladder_shard_pack_matches_reference(world):
    S = world[0]
    got = t_steps.ladder_shard_pack(ladder_values(), S)
    want = j_steps.ladder_shard_pack(ladder_values(), S)
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    assert sorted(got[2]) == sorted(want[2])
    for key in want[2]:
        for a, b in zip(got[2][key], want[2][key]):
            np.testing.assert_array_equal(a, b)
    assert got[3][0] == want[3][0]
    np.testing.assert_array_equal(got[3][1], want[3][1])


def test_ladder_sharded_decode(world):
    S, res, mesh = world
    flat = ladder_values()
    packed, counts, order, (toff, tail) = j_steps.ladder_shard_pack(flat, S)
    fn = _smap(lambda p, c: j_steps.ladder_sharded_decode_step(p, c), mesh,
               ({w: P("dp", None, None) for w in packed},
                {w: P("dp") for w in packed}),
               ({w: P("dp", None) for w in packed}, P()))
    outs, total = fn({w: jnp.asarray(a) for w, a in packed.items()},
                     {w: jnp.asarray(c) for w, c in counts.items()})
    rebuilt = np.empty_like(flat)
    blocks = rebuilt[:toff].reshape(-1, 256)
    for r, rr in enumerate(res):
        got, got_total = rr["ladder"]
        assert got_total == int(total) == toff
        for w, o in got.items():
            NBw = packed[w].shape[1]
            np.testing.assert_array_equal(
                o.view(np.uint32), np.asarray(outs[w])[r * NBw:(r + 1) * NBw])
            c = int(counts[w][r])
            blocks[order[w][r]] = o[:c].view(np.uint32)
    rebuilt[toff:] = tail
    np.testing.assert_array_equal(rebuilt, flat)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_run_ranks_raises_on_a_failing_rank():
    """Rank 1 raises while rank 0 waits in an all_reduce: the call
    raises with rank 1's traceback, and no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pdist.run_ranks(torch_ranks.failing_body, 2, "cpu", timeout_s=60)


def test_run_ranks_deadline():
    with pytest.raises(TimeoutError):
        pdist.run_ranks(torch_ranks.sleeping_body, 2, "cpu", (120,),
                        timeout_s=4)


def test_run_ranks_asks_for_cards_it_has():
    """NCCL runs one rank a card: more ranks than cards, or no card at
    all, raises before any rank starts; gloo is never taken instead."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        pdist.run_ranks(torch_ranks.sleeping_body, n + 1, "cuda", (0,))


def test_tensors_round_trip_u32_bits():
    a = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = pdist.to_tensors({"x": [a]}, "cpu")["x"][0]
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(pdist.to_numpy(t).view(np.uint32), a)
