"""The multi-rank dry run: statistics collection and decode, sharded.

The port's counterpart of ``__graft_entry__.dryrun_multichip``: the
same sequence, sizes and checks, each step run by ``n`` ranks of one
``torch.distributed`` group (``dist.run_ranks``: NCCL ranks on cards,
or gloo ranks on the CPU) instead of the devices of a JAX mesh.

    python -c "from dint_tpu_torch.parallel import dryrun; \\
        dryrun.dryrun_multichip(4, device='cpu')"

The host builds come first, in the calling process: a collection on
disk, its index built list-sharded by a spawn pool of 3 workers (equal
to the serial build) and its doc- and term-range shard sets.  Then
every rank runs:

1. the example dictionary, trained through ``stats/collectors.py``;
2. the raw ``decode_units`` over its quarter of the units (counts exact);
3. its slice of the sharded ladder decode (the caller reassembles the
   stream and holds it to the source and to ``UnpackEngine``);
4. ``stats_training_step`` (histogram mass exact);
5. the term-sharded AND, and the term- and doc-sharded top-k against
   numpy;
6. the real index served by ``serve_ranked_sharded``, doc-sharded
   (``serve_ranked_doc_sharded``) and term-sharded
   (``serve_ranked_term_sharded``), each against ``ranked.ranked_or``.

It prints one summary line.  Every check raises on failure.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from ..backend import resolve_device
from . import dist as pdist

K = 10


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def example_gap_lists():
    """24 gap lists of 64-699 ints, half zeros, half 1-499."""
    rng = np.random.default_rng(42)
    gap_lists = []
    for _ in range(24):
        n = int(rng.integers(64, 700))
        kind = rng.random(n)
        g = np.where(kind < 0.5, 0, rng.integers(1, 500, n)).astype(np.uint32)
        gap_lists.append(g)
    return gap_lists


def example_setup(device="cuda"):
    """The example gap lists, their dictionary trained through
    ``collectors.collect_single`` (merges on ``device``) and their
    ``encode_opt_single`` buffers: (decode view, gap lists, buffers)."""
    from ..codecs import dint
    from ..dictionary.builder import build_dictionary
    from ..stats import block_stats, collectors

    gap_lists = example_gap_lists()
    total = sum(len(g) for g in gap_lists)
    per_size = collectors.collect_single(gap_lists, device=device)
    ctx = block_stats._filter_sort(per_size, total)
    stats = block_stats.BlockStats(total, [ctx])
    d = build_dictionary(stats, "single")
    lt = d.lookup_table()
    view = d.decode_view()
    bufs = [dint.encode_opt_single(lt, g) for g in gap_lists]
    return view, gap_lists, bufs


def _replicated(items, n: int):
    """The reference's 4n units: the list repeated and cut."""
    return (items * ((n * 4) // len(items) + 1))[: n * 4]


def _blocks(lists_rep, n: int) -> np.ndarray:
    """Every full 256-int block of the units, zero-padded to a multiple
    of n blocks."""
    blocks = np.concatenate([g[: len(g) // 256 * 256].reshape(-1, 256)
                             for g in lists_rep if len(g) >= 256])
    pad = -blocks.shape[0] % n
    return np.concatenate([blocks, np.zeros((pad, 256), blocks.dtype)])


def step_inputs(n: int) -> dict:
    """The AND and top-k steps' inputs of ``n`` ranks (seed 0): 4 queries'
    16 candidates (``cand``) and every rank's term lists of 32 slots
    holding the first half of them (``lists``, 0xFFFFFFFF padded); 3
    queries' partial scores over 64 docs a rank (``parts``); each rank's
    64 docids and their complete scores (``ddocs``, ``dscores``)."""
    rng = np.random.default_rng(0)
    Q, C, L = 4, 16, 32
    cand = np.sort(rng.choice(500, (Q, C), replace=False)).astype(np.uint32)
    lists = np.full((n, Q, L), 0xFFFFFFFF, dtype=np.uint32)
    lists[:, :, : C // 2] = np.sort(cand[:, : C // 2], axis=1)[None]
    Qr, D = 3, 64
    parts = rng.random((n, Qr, D)).astype(np.float32)
    ddocs = np.stack([np.arange(s * D, (s + 1) * D, dtype=np.int32)[None, :]
                      .repeat(Qr, 0) for s in range(n)])
    dscores = rng.random((n, Qr, D)).astype(np.float32)
    return {"cand": cand, "lists": lists, "parts": parts, "ddocs": ddocs,
            "dscores": dscores}


def _serve_checks(paths, qs, device):
    """The real index on every rank: served one index doc-sharded, over
    doc-range shards and over term-range shards, each top-k against
    ``ranked_or``.  Returns the queries checked."""
    from ..index import dint_index
    from ..query import ranked
    from ..query.term_decode import TermDecoder
    from . import build as pbuild
    from . import serve

    idx = dint_index.DintIndex.load(paths["index"])
    wdata = ranked.WandData.load(paths["wand"])
    dec = TermDecoder(idx, device=device)
    want = [ranked.ranked_or(idx, dec, wdata, q, k=K) for q in qs]
    runs = {
        "one index": serve.serve_ranked_sharded(None, idx, dec, wdata, qs,
                                                k=K),
        "doc-range shards": serve.serve_ranked_doc_sharded(
            None, pbuild.DocShardedIndex.load(paths["doc_shards"]),
            wdata.norm_lens, qs, k=K, device=device),
        "term-range shards": serve.serve_ranked_term_sharded(
            None, pbuild.TermShardedIndex.load(paths["term_shards"]),
            wdata.norm_lens, qs, k=K, device=device),
    }
    for what, (vals, _) in runs.items():
        for qi, q in enumerate(qs):
            got = vals[qi][: want[qi].shape[0]]
            _check(got.shape == want[qi].shape
                   and np.allclose(got, want[qi], rtol=1e-4),
                   f"{what}: query {q} scores {got} != ranked_or {want[qi]}")
    return len(qs)


def _rank_body(rank, world, device, paths, qs):
    """Steps 1-6 of the module docstring on this rank's shard."""
    from ..kernels import decode_xla
    from . import steps

    n = world
    view, gap_lists, bufs = example_setup(device)
    out = {}

    # ---- raw decode: units sharded over the ranks, dictionary on each ----
    W, N = 1024, 1024
    bufs_rep = _replicated(bufs, n)
    lists_rep = _replicated(gap_lists, n)
    arena = np.frombuffer(b"".join(bufs_rep), dtype=np.uint8)
    starts = np.cumsum([0] + [len(b) for b in bufs_rep])[:-1]
    mine = slice(4 * rank, 4 * rank + 4)
    cw = decode_xla.tokens_from_arena(arena, starts[mine], W, 16)
    wv = np.asarray([len(b) // 2 for b in bufs_rep[mine]], np.int32)
    want_n = np.asarray([len(g) for g in lists_rep[mine]], np.int32)
    t = lambda a, dt=np.int32: pdist.to_tensors(np.asarray(a, dt), device)
    _, produced, _ = decode_xla.decode_units(
        t(cw), t(wv), t(want_n), t(np.zeros(4, np.int32)), t(view.lengths),
        t(view.offsets, np.uint32), t(view.table, np.uint32),
        b=16, n_out=N, assume_clean=False)
    _check(np.array_equal(produced.cpu().numpy(), want_n),
           f"rank {rank}: sharded decode produced wrong counts")
    out["decoded"] = int(want_n.sum())

    # ---- sharded ladder decode: this rank's block range ----
    flat = np.concatenate(lists_rep).astype(np.uint32)
    packed, pcounts, _, _ = steps.ladder_shard_pack(flat, n)
    pk = {w: t(a[rank], np.uint32) for w, a in packed.items()}
    ct = {w: int(c[rank]) for w, c in pcounts.items()}
    louts, ltotal = steps.ladder_sharded_decode_step(pk, ct)
    t0 = time.perf_counter()
    louts2, _ = steps.ladder_sharded_decode_step(pk, ct)  # rate only
    pdist.to_numpy(louts2)
    out["ladder_s"] = time.perf_counter() - t0
    out["ladder"] = {w: v[: ct[w]] for w, v in louts.items()}
    out["ladder_total"] = ltotal

    # ---- sharded statistics step: histogram summed over the ranks ----
    blocks = _blocks(lists_rep, n)
    per = blocks.shape[0] // n
    counts, _ = steps.stats_training_step(
        t(blocks[rank * per:(rank + 1) * per], np.uint32), n_buckets=1 << 12)
    mass = int(counts.sum())
    _check(mass == blocks.shape[0] * sum(256 // s for s in (16, 8, 4, 2, 1)),
           f"rank {rank}: stats histogram mass {mass}")
    out["stats_mass"] = mass

    # ---- term-sharded AND ----
    small = step_inputs(n)
    cand, lists = small["cand"], small["lists"]
    Q, C = cand.shape
    members = steps.term_sharded_and_step(
        t(cand, np.uint32), t(lists[rank], np.uint32),
        t(np.ones(Q, bool), bool))
    _check(int(members.sum()) == Q * (C // 2), "term-sharded AND")

    # ---- term-sharded ranked top-k ----
    parts = small["parts"]
    vals_k, _ = steps.term_sharded_topk_step(t(parts[rank], np.float32), K)
    want_ids = np.argsort(-parts.sum(axis=0), axis=1)[:, :K]
    want = np.sort(np.take_along_axis(parts.sum(axis=0), want_ids, axis=1),
                   axis=1)
    _check(np.allclose(np.sort(vals_k.cpu().numpy(), axis=1), want,
                       rtol=1e-5), "term-sharded top-k mismatch")

    # ---- doc-sharded ranked top-k (per-rank top-k, all_gather merge) ----
    ddocs, dscores = small["ddocs"], small["dscores"]
    dv, _ = steps.doc_sharded_topk_step(t(ddocs[rank]),
                                        t(dscores[rank], np.float32), K)
    want = np.sort(dscores.transpose(1, 0, 2).reshape(dscores.shape[1], -1),
                   axis=1)[:, -K:]
    _check(np.allclose(np.sort(dv.cpu().numpy(), axis=1), want, rtol=1e-6),
           "doc-sharded top-k mismatch")

    out["queries"] = _serve_checks(paths, qs, device)
    return out


def build_real_index(td: str, n: int):
    """The collection, its index built list-sharded by a 3-process spawn
    pool and held equal to the serial build, its wand data, and its
    doc- and term-range shard sets; returns (paths, queries)."""
    from ..index import dint_index
    from ..io import collection as coll_mod
    from ..io import synth
    from ..query import ranked
    from . import build as pbuild

    base = os.path.join(td, "dc")
    docs, freqs = synth.make_collection(24, 4000, seed=11, avg_len=90)
    coll_mod.write_freq_collection(base, docs, freqs, 4000)
    coll_mod.write_sizes_file(base,
                              synth.doc_sizes_from_lists(docs, freqs, 4000))
    idx = pbuild.build_index_sharded(base, kind="single", cache_dir=td,
                                     n_workers=3, serial=False)
    serial = dint_index.build_index(base, kind="single", cache_dir=td)
    _check(np.array_equal(idx.arena, serial.arena)
           and np.array_equal(idx.block_end, serial.block_end)
           and np.array_equal(idx.list_n, serial.list_n),
           "sharded build diverged from serial build")
    paths = {"index": os.path.join(td, "dc.idx.npz"),
             "wand": os.path.join(td, "dc.wand.npz"),
             "doc_shards": os.path.join(td, "dsh"),
             "term_shards": os.path.join(td, "tsh")}
    idx.save(paths["index"])
    ranked.build_wand_data(base).save(paths["wand"])
    pbuild.build_doc_sharded(base, paths["doc_shards"], n_shards=n,
                             n_workers=2)
    pbuild.build_term_sharded(base, paths["term_shards"], n_shards=n,
                              n_workers=2)
    rq = np.random.default_rng(3)
    nonempty = [t for t in range(24) if len(docs[t])]
    qs = [[int(t) for t in rq.choice(nonempty, size=int(rq.integers(1, 4)),
                                     replace=False)]
          for _ in range(6)]
    return paths, qs


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks on ``device`` ("cuda": one
    NCCL rank a card; "cpu": gloo ranks), print its summary line and
    return the summary."""
    from ..kernels import unpack_device
    from . import steps

    dev = resolve_device(device)
    n = int(n_devices)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dint_dryrun_") as td:
        paths, qs = build_real_index(td, n)
        build_s = time.perf_counter() - t0
        res = pdist.run_ranks(_rank_body, n, dev, (paths, qs))
    flat = np.concatenate(_replicated(example_gap_lists(), n)).astype(
        np.uint32)
    _, pcounts, porder, (tail_off, tail_vals) = steps.ladder_shard_pack(flat,
                                                                        n)
    nb_full = (flat.shape[0] - tail_vals.shape[0]) // 256
    rebuilt = np.empty_like(flat)
    rb_blocks = rebuilt[: nb_full * 256].reshape(nb_full, 256)
    for r, rr in enumerate(res):
        for w, o in rr["ladder"].items():
            rb_blocks[porder[w][r]] = o.view(np.uint32)
    rebuilt[tail_off:] = tail_vals
    _check(np.array_equal(rebuilt, flat), "sharded ladder decode != source")
    eng = unpack_device.UnpackEngine(
        unpack_device.ladder_plan_from_values(flat), device=dev)
    _check(np.array_equal(eng.decode_all_ordered(), flat),
           "single-device ladder engine != source")
    ltotal = res[0]["ladder_total"]
    _check(ltotal == nb_full * 256 and all(r["ladder_total"] == ltotal
                                           for r in res),
           f"ladder count {ltotal} != {nb_full * 256}")
    summary = {
        "ranks": n, "device": str(dev),
        "backend": "nccl" if dev.type == "cuda" else "gloo",
        "decoded_ints": sum(r["decoded"] for r in res),
        "ladder_ints": ltotal,
        "ladder_rank_s": max(r["ladder_s"] for r in res),
        "stats_mass": res[0]["stats_mass"],
        "queries": res[0]["queries"],
        "host_build_s": build_s,
        "wall_s": time.perf_counter() - t0,
    }
    print(
        f"dryrun_multichip ok: {n} {summary['backend']} ranks on "
        f"{dev.type}, decoded {summary['decoded_ints']} ints, sharded "
        f"ladder decode exact ({ltotal} ints block-parallel over {n} "
        f"ranks, reassembly == source == single-device engine), stats "
        f"histogram mass {summary['stats_mass']}, term-sharded AND "
        f"verified, term-sharded top-{K} verified, doc-sharded top-{K} "
        f"(all_gather merge) verified, REAL single_packed_dint index built "
        f"SHARDED (3 ranges, spawn pool, ordered commit == serial build) "
        f"and served over {n} ranks as one index, as {n} doc-range "
        f"indexes and as {n} term-range indexes (all_to_all repartition), "
        f"{summary['queries']} queries each equal to ranked_or; "
        f"{summary['wall_s']:.1f} s", flush=True)
    return summary
