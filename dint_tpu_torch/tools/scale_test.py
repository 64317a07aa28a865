"""Large-scale pipeline shakedown on the card: the port of the reference
package's ``scripts/scale_test.py``.

    python -m dint_tpu_torch.tools.scale_test [--ints 1e8]
        [--num-lists 20000] [--decode] [--serve] [--serve-sharded]
        [--build-doc-sharded] [--build-pef-index] [--pef-kind opt]
        [--shards 8] [--sharded-queries 32] [--queries 512] [--runs 5]
        [--cache-dir DIR] [--device cuda|cpu] [--record FILE]
        [--profile-runs N]

Synthesizes a Gov2-shaped collection (``--ints`` requested postings
over ``--num-lists`` lists, seed 11: 1e8 gives 90.8M postings), then
runs the build stages, each timed with its peak RSS: the collection
written and counted, the single_rect_dint dictionary trained and the
stream encoded (``tools.encode.encode_collection``, its collectors'
merges on ``--device``).  Every stage is create-or-load cached under
``--cache-dir`` (``.scale_torch/`` at the checkout's root, never the
reference's ``.scale/``), so reruns resume; a cache made with other
``--ints``/``--num-lists`` is refused.  Then every stage flag given runs,
in this order (the reference runs one a process):

``--decode``
    ``tools.decode.decode_stream`` over the stream, each leg checked
    against the whole collection: the gather image (one fused K1-K3
    launch a run) and the ladder image (one X1 launch a run).
``--serve``
    a multi_packed_dint index, ``.sizes``, wand data and a log of
    ``--queries`` queries (seed 23); ``wand`` through the fused store
    (K4, Block-Max survival on the card), the host ``wand`` and
    ``ranked_or`` on the log's first 64 queries, device and host AND,
    and ``device_batch.ranked_or_batch`` against the host ``ranked_or``
    on 20 queries.
``--serve-sharded``
    that index served by ``parallel.serve.serve_ranked_sharded`` on
    ``--shards`` ranks of ``parallel.dist.run_ranks`` (on ``cuda`` NCCL,
    one rank a card; on ``cpu`` gloo ranks), against the host
    ``ranked_or``.
``--build-doc-sharded``
    ``parallel.build.build_doc_sharded`` into ``--shards`` self-contained
    single_packed_dint shards served by ``serve_ranked_doc_sharded`` on
    the same ranks, against an unsharded index's ``ranked_or``; then 25
    terms (seed 7) decoded from the shards against the collection.
``--build-pef-index``
    an EF-family index (``--pef-kind``) built on the host, 50 lists
    (seed 17) against the collection, ``wand`` against ``ranked_or`` on
    16 queries.

Everything runs on ``--device`` (``cuda`` by default; with no card that
raises).  Every check raises on failure.  ``--record FILE`` writes one
JSON line, also when a stage fails (then with its ``error``): the card,
the postings, every stage's wall seconds, peak RSS and the card's peak
allocation, both decode legs' rates, image bytes an int and cold starts,
the serve µs a query of every op, and every check's result.
``--profile-runs N`` (card only) adds to each decode leg N chained runs
under torch.profiler (wall against busy a run, against the bytes bound)
and its one launch a run timed alone against its bytes bound; for the
gather leg also the zero class alone in the fused launch against its
bytes bound.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import tempfile
import time
import traceback

import numpy as np
import torch

from ..backend import device_name, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(REPO, ".scale_torch")
STREAM = "scale.single_rect_dint.bin"
K = 10
# Published H100 device-memory rates (NVIDIA data sheets), by card name.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))
LAUNCH_ITERS = 20  # CUDA-event timings of a leg's launch alone
# the sharded stages' ranks, spawn to join (run_ranks' 300 s default is
# too short at 10^8 postings and above)
RANK_TIMEOUT_S = 3600.0


def _vmhwm_gib() -> float:
    """Peak RSS of this process so far, in GiB: VmHWM, or where the
    kernel does not report it the rusage maximum (both in KiB)."""
    kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    kib = max(kib, int(line.split()[1]))
    except OSError:
        pass
    return kib / (1 << 20)


class Stages:
    """The ``[scale]`` stage lines of a run and their entries for the
    record: wall seconds, peak RSS and, on a card, the card's peak
    allocation since the stage before."""

    def __init__(self, device: torch.device, echo: bool = True):
        self.device = device
        self.echo = echo
        self.entries = []

    def say(self, msg: str) -> None:
        if self.echo:
            print(f"[scale] {msg}", flush=True)

    def stage(self, name: str, t0: float) -> float:
        dt = time.perf_counter() - t0
        entry = {"stage": name, "wall_s": dt, "peak_rss_gib": _vmhwm_gib()}
        if self.device.type == "cuda":
            entry["card_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.entries.append(entry)
        self.say(f"{name}: {dt:.1f}s (peak rss {entry['peak_rss_gib']:.1f} "
                 "GiB)")
        return time.perf_counter()


class ScaleRun:
    """One invocation: its arguments, cache directory, device, stage
    log and record."""

    def __init__(self, args):
        self.args = args
        self.cache = os.path.abspath(args.cache_dir or DEFAULT_CACHE)
        self.device = resolve_device(args.device)
        self.stages = Stages(self.device)
        self.base = os.path.join(self.cache, "scale_collection")
        self.record = {
            "tool": "dint_tpu_torch.tools.scale_test",
            "ints": args.ints, "num_lists": args.num_lists,
            "device": device_name(self.device),
            "nvidia_smi": card_line() if self.device.type == "cuda" else None,
            "checks": {},
        }

    def path(self, name: str) -> str:
        return os.path.join(self.cache, name)

    def stage(self, name: str, t0: float) -> float:
        return self.stages.stage(name, t0)

    def check(self, name: str) -> None:
        self.record["checks"][name] = "ok"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no published memory rate for {name!r}")


def doc_sizes(view) -> np.ndarray:
    """Every document's summed freqs over the collection, at least 1, as
    u32: the reference's ``np.add.at`` over every posting, as one
    ``bincount`` a chunk of about 16M postings.  A document appears once
    a list, so a chunk's float64 sums of u32 freqs stay exact below 2^21
    lists."""
    sizes = np.zeros(view.num_docs, np.int64)
    docs, freqs, held = [], [], 0

    def flush():
        d = np.concatenate(docs).astype(np.int64)
        f = np.concatenate(freqs).astype(np.float64)
        sizes[:] += np.bincount(d, weights=f,
                                minlength=view.num_docs).astype(np.int64)
        docs.clear()
        freqs.clear()

    for d, f in view:
        docs.append(d)
        freqs.append(f)
        held += d.shape[0]
        if held >= 1 << 24:
            flush()
            held = 0
    if docs:
        flush()
    return np.maximum(sizes, 1).astype(np.uint32)


def ensure_serving_files(run: ScaleRun) -> None:
    """``.sizes``, the wand data and the query log, each made once."""
    from ..io import collection as coll_mod
    from ..query import ranked

    t = time.perf_counter()
    base = run.base
    if not os.path.exists(base + ".sizes"):
        coll_mod.write_sizes_file(
            base, doc_sizes(coll_mod.open_freq_collection(base)))
        t = run.stage("synthesize .sizes", t)
    wand_file = run.path("scale.wand")
    if not os.path.exists(wand_file + ".npz"):
        ranked.build_wand_data(base).save(wand_file)
        t = run.stage("create_wand_data", t)
    qlog = run.path("scale.queries")
    if not os.path.exists(qlog):
        nl = len(coll_mod.open_freq_collection(base))
        rng = np.random.default_rng(23)
        with open(qlog, "w") as f:
            for _ in range(run.args.queries):
                k = int(rng.integers(1, 5))
                f.write(" ".join(str(int(x)) for x in
                                 rng.integers(0, nl, k)) + "\n")


def check_topk(got, want, what: str, rtol: float = 1e-4) -> None:
    got = np.asarray(got)[: want.shape[0]]
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol):
        raise RuntimeError(f"{what}: top-{K} {got} != ranked_or {want}")


# ---------------------------------------------------------------------------
# build stages
# ---------------------------------------------------------------------------


def build_stages(run: ScaleRun) -> str:
    """Synthesize, write, count, train and encode; returns the stream."""
    from ..io import collection, synth
    from . import encode

    args = run.args
    os.makedirs(run.cache, exist_ok=True)
    params = {"ints": args.ints, "num_lists": args.num_lists}
    pfile = run.path("scale.params.json")
    if os.path.exists(pfile):
        with open(pfile) as f:
            held = json.load(f)
        if held != params:
            raise SystemExit(f"{run.cache} holds a collection of {held}, "
                             f"not {params}: pass another --cache-dir")
    base = run.base
    avg_len = args.ints / args.num_lists
    num_docs = int(args.ints // 4)

    t = time.perf_counter()
    if not os.path.exists(base + ".docs"):
        docs, freqs = synth.make_collection(
            args.num_lists, num_docs, seed=11, avg_len=avg_len)
        collection.write_freq_collection(base, docs, freqs, num_docs)
        del docs, freqs
        with open(pfile, "w") as f:
            json.dump(params, f)
    t = run.stage("synthesize+write", t)

    coll = collection.open_freq_collection(base)
    total = int(sum(len(d) for d, _ in coll))
    run.record["postings"] = total
    run.stages.say(f"collection: {args.num_lists} lists, {total} postings")
    t = run.stage("count", t)

    stream = run.path(STREAM)
    if not os.path.exists(stream):
        # an image or plan cached beside an earlier stream of this name
        # would describe other bytes
        for f in os.listdir(run.cache):
            if f.startswith(STREAM + ".") and (".plan." in f
                                               or ".image." in f):
                os.remove(run.path(f))
        encode.encode_collection("single_rect_dint", base + ".docs", stream,
                                 cache_dir=run.cache, device=run.device)
    run.stage("dict-train + encode", t)
    return stream


def dict_file(run: ScaleRun) -> str:
    return run.path("dict.scale_collection.docs.rectangular.DSF-65536-16")


# ---------------------------------------------------------------------------
# --decode
# ---------------------------------------------------------------------------


def _chain(dec, engine: str):
    if engine == "ladder":
        return lambda runs: dec.engine.chain(runs)
    return lambda runs: dec.engine.decode_chain(runs)


def profile_runs(fn, runs: int) -> dict:
    """Where ``fn()`` (``runs`` chained runs) spends its time: one
    warm-up call, then one under torch.profiler; busy is the union of
    the card's kernel, memset and memcpy intervals, idle its share of
    the host's wall time of the call (which ends in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        trace = os.path.join(td, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    out = {"runs": runs, "wall_us_per_run": wall * 1e6 / runs}
    if not dev:
        out["busy_us_per_run"] = "not measured"
        return out
    busy, end, by_name = 0.0, dev[0][0], {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update({
        "busy_us_per_run": busy / runs,
        "idle_share_of_wall": 1.0 - busy / 1e6 / wall,
        "busy_us_per_run_by_name": {k: v / runs for k, v in top},
    })
    return out


def time_launch(fn, iters: int = LAUNCH_ITERS) -> float:
    """Mean milliseconds of ``fn()`` (one launch) over ``iters`` back to
    back, CUDA events, after one warm-up call: the image and the output
    of the scale stream are larger than the L2, so none is flushed.  The
    card first sleeps ~25 ms, so that the host has queued every launch
    before the card reaches them: the events time the card's work, not
    the host's launch latency."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def fused_launch(dec, rate: float) -> dict:
    """The gather leg's one launch a run (the fused K1-K3 class launch)
    at this stream's size: its rows by class, the bytes it must move
    (the engine's image on the card read once, trimmed, the output
    written once) and their time at ``rate``, and its time alone; the
    same for the zero class alone in the launch (no u16 or i32 rows)."""
    from ..kernels import decode_local as dl

    eng, img = dec.engine, dec.engine.image
    salt = torch.ones(1, dtype=torch.int64, device=eng.device)
    nbytes = 8 + eng.rows * dl.N_OUT * 4 + eng.card_bytes()
    rec = {"rows": {"zero": int(img.n0.shape[0]),
                    "u16": int(img.n16.shape[0]),
                    "i32": int(img.n32.shape[0])},
           "padded_rows": {str(c.mode): c.rows for c in eng._classes},
           "bytes": nbytes, "bound_us": nbytes / rate * 1e6,
           "us": time_launch(lambda: eng._run(salt)) * 1e3}
    c0 = next(c for c in eng._classes if c.mode == 0)
    if c0.rows:
        zero_bytes = 8 + c0.rows * (4 + dl.N_OUT * 4)
        out = torch.empty((c0.rows, dl.N_OUT), dtype=torch.int32,
                          device=eng.device)
        ms = time_launch(lambda: dl.decode_classes(c0.n, None, None, salt,
                                                   out=out))
        rec.update({"zero_class_bytes": zero_bytes,
                    "zero_class_bound_us": zero_bytes / rate * 1e6,
                    "zero_class_us": ms * 1e3})
    return rec


def x1_launch(dec, rate: float) -> dict:
    """The ladder leg's one launch a run (X1) at this stream's size: its
    classes, the bytes it must move (words and bases read once, every
    value written once) and their time at ``rate``, and its time
    alone."""
    from ..kernels import unpack_device as ud

    lc = dec.engine._x1
    salt = torch.ones(1, dtype=torch.int64, device=lc.device)
    nbytes = 8 + lc.buf.numel() * 4 + sum(
        wT.numel() * 4 + (bT.numel() * 4 if bT is not None else 0)
        for _, wT, bT in lc.classes)
    ms = time_launch(lambda: ud.ladder_unpack(lc, salt))
    return {"classes": [[int(w), int(wT.numel())] for w, wT, _ in lc.classes],
            "bytes": nbytes, "bound_us": nbytes / rate * 1e6,
            "us": ms * 1e3}


def decode_stage(run: ScaleRun, stream: str) -> None:
    from . import decode as dtool

    args, dev = run.args, run.device
    t = time.perf_counter()
    legs = {}
    for leg, engine, label in (("gather", "local", "gather decode"),
                               ("ladder", "ladder", "ladder decode")):
        rec = dtool.decode_stream(
            "single_rect_dint", stream, dict_file(run), runs=args.runs,
            check_collection=run.base + ".docs", engine=engine, device=dev)
        if rec.get("check") != "ok":
            raise RuntimeError(f"{leg} leg: the collection check did not "
                               "pass")
        run.check(f"{leg}_collection")
        n = int(rec["num_integers"])
        legs[leg] = {
            "ints_x_sec": float(rec["ints_x_sec"]), "num_integers": n,
            "image_bytes": int(rec["plan_bytes"]),
            "image_B_per_int": int(rec["plan_bytes"]) / n,
            "cold_start_s": float(rec["cold_start_s"]),
            "us_per_run": float(rec["tot_elapsed_time"]) * 1e6,
            "runs": args.runs, "check": rec["check"]}
        if "rows" in rec:
            legs[leg]["rows"] = int(rec["rows"])
        mib = int(rec["plan_bytes"]) / (1 << 20)
        extra = (f", cold_start {rec['cold_start_s']}s" if leg == "gather"
                 else "")
        t = run.stage(f"{label} (timed, full check): {rec['ints_x_sec']} "
                      f"ints/s, image {mib:.0f} MiB{extra}", t)
        if args.profile_runs:
            rate = hbm_rate(device_name(dev))
            dec = dtool.open_decoder("single_rect_dint", stream,
                                     dict_file(run), engine, dev)
            prof = profile_runs(lambda: _chain(dec, engine)(args.profile_runs),
                                args.profile_runs)
            prof["bound_us_per_run"] = (
                (int(rec["plan_bytes"]) + 4 * n) / rate * 1e6)
            legs[leg]["profile"] = prof
            legs[leg]["launch"] = (fused_launch(dec, rate) if leg == "gather"
                                   else x1_launch(dec, rate))
            del dec
            torch.cuda.empty_cache()
            t = run.stage(f"{label}: profile of {args.profile_runs} runs", t)
    run.record["decode"] = legs
    run.stages.say(f"OK {int(legs['gather']['ints_x_sec'])} ints/s")


# ---------------------------------------------------------------------------
# --serve
# ---------------------------------------------------------------------------


def _us(stats) -> dict:
    return {key: float(stats[key]) for key in ("avg", "q50", "q95")}


def serve_stage(run: ScaleRun) -> None:
    """The reference's config-5 analog at synthetic scale:
    multi_packed_dint index build, create_wand_data and WAND top-10
    through the device and host engines over the query log."""
    from ..index import dint_index
    from ..query import boolean, device_batch, ranked
    from ..query.term_decode import TermDecoder
    from . import queries as qtool

    dev = run.device
    t = time.perf_counter()
    idx_file = run.path("scale.idx.mpd.bin")
    if not os.path.exists(idx_file + ".npz"):  # save() writes .npz parts
        idx = dint_index.build_index(run.base, kind="multi",
                                     cache_dir=run.cache)
        idx.save(idx_file)
        t = run.stage("multi_packed_dint index build", t)
    idx = dint_index.DintIndex.load(idx_file)
    t = run.stage("index load", t)
    ensure_serving_files(run)
    wdata = ranked.WandData.load(run.path("scale.wand"))
    queries_list = boolean.parse_query_log(run.path("scale.queries"))
    dec = TermDecoder(idx, device=dev)
    serve = {"queries": len(queries_list)}

    stats, shape, dev_extra = qtool.run_op_device(
        idx, dec, wdata, queries_list, "wand", 3, K)
    run.stages.say(f"device wand batch {shape}: {stats['avg']:.1f}us avg, "
                   f"q95 {stats['q95']:.1f}us/query {dev_extra}")
    serve["device_wand_us"] = _us(stats)
    serve["device_wand_batch"] = list(shape)
    serve["device_wand"] = dev_extra
    t = run.stage("device wand batch", t)
    # host skip-aware wand on a subset (the walk over pivots is Python;
    # unions of uniform weights prune weakly)
    sub = queries_list[:64]
    stats = qtool.run_op(idx, dec, wdata, sub, "wand", 1, K)
    run.stages.say(f"host wand ({len(sub)} queries, decode-inclusive): "
                   f"avg {stats['avg']:.1f}us, q50 {stats['q50']:.1f}us, "
                   f"q95 {stats['q95']:.1f}us")
    serve["host_wand_us"] = _us(stats)
    tot = dec._lazy_totals
    run.stages.say(f"host wand pruning (all timed queries): "
                   f"{tot['docs_blocks']} doc blocks decoded, "
                   f"{tot['postings_scored']} postings scored")
    serve["host_wand_pruning"] = dict(tot)
    t = run.stage("host wand subset", t)
    stats = qtool.run_op(idx, dec, wdata, sub, "ranked_or", 1, K)
    run.stages.say(f"host ranked_or ({len(sub)} queries): "
                   f"avg {stats['avg']:.1f}us, q50 {stats['q50']:.1f}us")
    serve["host_ranked_or_us"] = _us(stats)
    t = run.stage("host ranked_or subset", t)
    stats, shape, _ = qtool.run_op_device(idx, dec, wdata, queries_list,
                                          "and", 3, K)
    run.stages.say(f"device AND batch {shape}: {stats['avg']:.1f}us avg")
    serve["device_and_us"] = _us(stats)
    stats = qtool.run_op(idx, dec, wdata, queries_list, "and", 3, K)
    run.stages.say(f"host AND: p50 {stats['q50']:.1f}us, avg "
                   f"{stats['avg']:.1f}us")
    serve["host_and_us"] = _us(stats)
    t = run.stage("boolean", t)

    # exactness spot-check: device ranked against the host oracle
    sample = queries_list[:20]
    got = device_batch.ranked_or_batch(idx, dec, wdata, sample, k=K)
    for q, g in zip(sample, got):
        want = ranked.ranked_or(idx, dec, wdata, q, k=K)
        np.testing.assert_allclose(g, want, rtol=1e-3)
    run.check("serve_device_topk_20")
    run.record["serve"] = serve
    run.stages.say(f"device ranked top-{K} matches host oracle on "
                   f"{len(sample)} queries")
    run.stage("device ranked spot-check", t)


# ---------------------------------------------------------------------------
# --serve-sharded and --build-doc-sharded: SPMD ranks
# ---------------------------------------------------------------------------


def serve_sharded_rank(rank, world, device, paths, n_queries):
    """One rank of ``--serve-sharded``: the index served doc-sharded by
    ``serve_ranked_sharded``; rank 0 holds every query to the host
    ``ranked_or`` (no rank holds the result alone)."""
    from ..index import dint_index
    from ..parallel import serve
    from ..query import boolean, ranked
    from ..query.term_decode import TermDecoder

    st = Stages(device, echo=rank == 0)
    t = time.perf_counter()
    idx = dint_index.DintIndex.load(paths["index"])
    wdata = ranked.WandData.load(paths["wand"])
    qs = boolean.parse_query_log(paths["queries"])[:n_queries]
    dec = TermDecoder(idx, device=device)
    t = st.stage("sharded: load index + wand + queries", t)
    vals, _ = serve.serve_ranked_sharded(None, idx, dec, wdata, qs, k=K)
    t = st.stage(f"sharded: {len(qs)} queries doc-sharded over {world} "
                 "ranks (rows + sharded steps)", t)
    if rank == 0:
        for qi, q in enumerate(qs):
            check_topk(vals[qi], ranked.ranked_or(idx, dec, wdata, q, k=K),
                       f"sharded query {qi} {q}")
        st.stage("sharded: host ranked_or oracle parity", t)
    return {"vals": vals, "stages": st.entries, "queries": len(qs),
            "num_lists": idx.num_lists}


def serve_sharded_stage(run: ScaleRun) -> np.ndarray:
    """The real multi_packed index served doc-sharded over ``--shards``
    ranks, exact parity with the host ``ranked_or`` oracle; returns the
    top-k scores (queries, k)."""
    from ..parallel import dist as pdist

    paths = {"index": run.path("scale.idx.mpd.bin"),
             "wand": run.path("scale.wand"),
             "queries": run.path("scale.queries")}
    needed = [paths["index"] + ".npz", paths["wand"] + ".npz",
              paths["queries"]]
    missing = [f for f in needed if not os.path.exists(f)]
    if missing:
        raise SystemExit(
            "--serve-sharded needs the artifacts a --serve run creates; "
            f"missing: {missing}.  Run with --serve first.")
    t = time.perf_counter()
    res = pdist.run_ranks(serve_sharded_rank, run.args.shards, run.device,
                          (paths, run.args.sharded_queries),
                          timeout_s=RANK_TIMEOUT_S)
    run.stages.entries += res[0]["stages"]
    run.stage(f"sharded: {run.args.shards} ranks, spawn to join", t)
    run.check("sharded_serve_topk")
    run.record["sharded_serve"] = {"ranks": run.args.shards,
                                   "queries": res[0]["queries"]}
    run.stages.say(f"sharded serve ok: {res[0]['queries']} queries, top-{K} "
                   "exact parity with the host oracle on the "
                   f"{res[0]['num_lists']}-list index")
    return res[0]["vals"]


def doc_sharded_rank(rank, world, device, paths, n_queries):
    """One rank of ``--build-doc-sharded``: its shard of the set served
    by ``serve_ranked_doc_sharded`` (global statistics, all_gather
    merge)."""
    from ..parallel import build as pbuild
    from ..parallel import serve
    from ..query import boolean, ranked

    st = Stages(device, echo=rank == 0)
    t = time.perf_counter()
    sharded = pbuild.DocShardedIndex.load(paths["doc_shards"])
    wdata = ranked.WandData.load(paths["wand"])
    qs = boolean.parse_query_log(paths["queries"])[:n_queries]
    vals, _ = serve.serve_ranked_doc_sharded(None, sharded, wdata.norm_lens,
                                             qs, k=K, device=device)
    st.stage(f"doc-sharded: {len(qs)} queries served from {world} "
             "self-contained shards (decode + sharded step)", t)
    return {"vals": vals, "stages": st.entries}


def doc_sharded_stage(run: ScaleRun) -> np.ndarray:
    """Doc-sharded construction and serving at scale: the collection
    partitions into per-doc-range shard collections, each shard builds a
    self-contained single_packed index (its own dictionaries), and the
    shard set serves queries with global BM25 statistics, exact against
    ``ranked_or`` on an unsharded index; returns the top-k scores
    (queries, k)."""
    from ..index import dint_index
    from ..io import collection as coll_mod
    from ..parallel import build as pbuild
    from ..parallel import dist as pdist
    from ..query import boolean, ranked
    from ..query.term_decode import TermDecoder

    args, dev, base = run.args, run.device, run.base
    if not (os.path.exists(base + ".docs")
            and os.path.exists(base + ".freqs")):
        raise SystemExit("--build-doc-sharded needs the scale collection; "
                         "run the build stages first (matching "
                         "--ints/--cache-dir)")
    ensure_serving_files(run)
    out_dir = run.path("doc_shards")
    t = time.perf_counter()
    if not os.path.exists(os.path.join(out_dir, "catalog.npz")):
        pbuild.build_doc_sharded(base, out_dir, args.shards, kind="single")
        t = run.stage(f"doc-sharded: partition + {args.shards} "
                      "self-contained shard builds (own dicts)", t)
    sharded = pbuild.DocShardedIndex.load(out_dir)
    if len(sharded.shards) != args.shards:
        raise SystemExit(
            f"cached shard set has {len(sharded.shards)} shards but "
            f"--shards={args.shards}; delete {out_dir} to rebuild")
    t = run.stage("doc-sharded: load shard set", t)
    shard_postings = [int(s.list_n.astype(np.int64).sum())
                      for s in sharded.shards]
    run.stages.say("shard postings: "
                   + " ".join(str(n) for n in shard_postings))

    oracle_file = run.path("scale.idx.spd.bin")
    if not os.path.exists(oracle_file + ".npz"):
        dint_index.build_index(base, kind="single",
                               cache_dir=run.cache).save(oracle_file)
        t = run.stage("doc-sharded: unsharded oracle index build", t)
    paths = {"doc_shards": out_dir, "wand": run.path("scale.wand"),
             "queries": run.path("scale.queries")}
    res = pdist.run_ranks(doc_sharded_rank, args.shards, dev,
                          (paths, args.sharded_queries),
                          timeout_s=RANK_TIMEOUT_S)
    run.stages.entries += res[0]["stages"]
    t = run.stage(f"doc-sharded: {args.shards} ranks, spawn to join", t)
    vals = res[0]["vals"]

    idx = dint_index.DintIndex.load(oracle_file)
    wdata = ranked.WandData.load(run.path("scale.wand"))
    qs = boolean.parse_query_log(run.path("scale.queries"))[
        : args.sharded_queries]
    dec = TermDecoder(idx, device=dev)
    for qi, q in enumerate(qs):
        check_topk(vals[qi], ranked.ranked_or(idx, dec, wdata, q, k=K),
                   f"doc-sharded query {qi} {q}")
    run.check("doc_sharded_topk")
    t = run.stage("doc-sharded: host ranked_or oracle parity", t)
    # decode spot-check: terms rebuilt from the shard set (shard-local
    # docids + doc_lo offsets) equal the collection
    view = coll_mod.open_freq_collection(base)
    lens = np.asarray(idx.list_n, np.int64)
    rng = np.random.default_rng(7)
    picks = rng.choice(np.flatnonzero(lens > 0),
                       size=min(25, int((lens > 0).sum())), replace=False)
    shard_decs = [TermDecoder(sh, device=dev) for sh in sharded.shards]
    for t_id in picks:
        t_id = int(t_id)
        parts = [sd.decode_docids([t_id])[t_id].astype(np.int64)
                 + int(sharded.doc_lo[j]) for j, sd in enumerate(shard_decs)]
        got = np.concatenate([p for p in parts if p.size])
        want = np.asarray(view.docs.sequence(t_id + 1), np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"term {t_id}")
        fparts = [sd.decode_freqs([t_id])[t_id] for sd in shard_decs]
        gotf = np.concatenate([p for p in fparts if p.size])
        np.testing.assert_array_equal(
            gotf, np.asarray(view.freqs.sequence(t_id)),
            err_msg=f"term {t_id}")
    run.check("doc_sharded_spot_check")
    run.stage(f"doc-sharded: decode spot-check {picks.size} terms "
              "(docs+freqs exact)", t)
    total = int(idx.list_n.astype(np.int64).sum())
    run.record["doc_sharded"] = {"ranks": args.shards, "queries": len(qs),
                                 "shard_postings": shard_postings,
                                 "spot_check_terms": int(picks.size)}
    run.stages.say(f"doc-sharded ok: {len(qs)} queries, top-{K} exact "
                   f"parity; no shard holds more than {max(shard_postings)} "
                   f"of {total} postings")
    return vals


# ---------------------------------------------------------------------------
# --build-pef-index
# ---------------------------------------------------------------------------


def pef_index_stage(run: ScaleRun) -> None:
    """The PEF index family at scale: an opt/uniform freq_index over the
    scale collection with the native partitioning DP, its size, decode
    exactness on a sample of lists and WAND against ``ranked_or`` over
    the skipping enumerators, all on the host."""
    from ..index import freq_index
    from ..io import collection as coll_mod
    from ..query import boolean, ranked

    kind, base = run.args.pef_kind, run.base
    if not os.path.exists(base + ".docs"):
        raise SystemExit("needs the scale collection; run the build "
                         "stages first (matching --ints/--cache-dir)")
    t = time.perf_counter()
    idx_file = run.path(f"scale.{kind}.idx")
    if not os.path.exists(idx_file + ".npz"):
        idx = freq_index.build_freq_index(base, kind)
        t = run.stage(f"pef-index: build_freq_index({kind})", t)
        idx.save(idx_file)
        t = run.stage("pef-index: save", t)
    idx = freq_index.FreqIndexEF.load(idx_file)
    t = run.stage("pef-index: load", t)
    size = idx.size_stats()
    run.stages.say(f"pef-index size: {size}")

    view = coll_mod.open_freq_collection(base)
    lens = np.asarray(idx.list_n, np.int64)
    rng = np.random.default_rng(17)
    picks = rng.choice(np.flatnonzero(lens > 0),
                       size=min(50, int((lens > 0).sum())), replace=False)
    for t_id in picks:
        t_id = int(t_id)
        np.testing.assert_array_equal(
            idx.list_docids(t_id),
            np.asarray(view.docs.sequence(t_id + 1), np.uint64),
            err_msg=f"term {t_id} docs")
        np.testing.assert_array_equal(
            idx.list_freqs(t_id),
            np.asarray(view.freqs.sequence(t_id), np.uint64),
            err_msg=f"term {t_id} freqs")
    run.check("pef_spot_check")
    t = run.stage(f"pef-index: decode spot-check {picks.size} terms "
                  "(docs+freqs exact)", t)
    pef = {"kind": kind, "size": size, "spot_check_terms": int(picks.size)}
    wand_file = run.path("scale.wand")
    qlog = run.path("scale.queries")
    if os.path.exists(wand_file + ".npz") and os.path.exists(qlog):
        wdata = ranked.WandData.load(wand_file)
        qs = boolean.parse_query_log(qlog)[:16]
        dec = freq_index.EFTermDecoder(idx, device=run.device)
        for q in qs:
            want = ranked.ranked_or(idx, dec, wdata, q, k=K)
            got = ranked.wand(idx, dec, wdata, q, k=K)
            if got.shape != want.shape or not np.allclose(got, want,
                                                          rtol=1e-4):
                raise RuntimeError(f"pef-index: wand {got} != ranked_or "
                                   f"{want} for {q}")
        c = dec.lazy_cache
        run.check("pef_wand_topk")
        pef.update({"wand_queries": len(qs), "enumerator_moves": c.moves,
                    "postings_scored": c.postings_scored})
        run.stage(f"pef-index: wand == ranked_or on {len(qs)} queries "
                  f"(enumerator moves {c.moves}, postings scored "
                  f"{c.postings_scored})", t)
    run.record["pef_index"] = pef
    run.stages.say("pef-index OK")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ints", type=float, default=1e8)
    ap.add_argument("--num-lists", type=int, default=20000)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--serve-sharded", action="store_true")
    ap.add_argument("--build-doc-sharded", action="store_true")
    ap.add_argument("--build-pef-index", action="store_true")
    ap.add_argument("--pef-kind", default="opt",
                    choices=["ef", "single", "uniform", "opt"])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--sharded-queries", type=int, default=32)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--cache-dir", default=None,
                    help="the stage cache (default .scale_torch at the "
                         "checkout's root; e.g. .scale1e9_torch for the "
                         "10^9 rehearsal: --ints 1e9 --cache-dir "
                         ".scale1e9_torch --decode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--record", metavar="FILE",
                    help="write the run's record here as one JSON line")
    ap.add_argument("--profile-runs", type=int, default=0,
                    help="chained runs of each decode leg under "
                         "torch.profiler, and its launch timed alone "
                         "(card only; 0: none)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the stages ``argv`` names; return the record."""
    args = parse_args(argv)
    run = ScaleRun(args)
    if args.profile_runs and run.device.type != "cuda":
        raise SystemExit("--profile-runs measures the card: it needs "
                         "--device cuda")
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t_all = time.perf_counter()
    try:
        # the sharded and PEF stages read the artifacts of earlier runs;
        # the build stages run when nothing else, --decode or --serve is
        # asked for
        only_later = (args.serve_sharded or args.build_doc_sharded
                      or args.build_pef_index) and not (args.decode
                                                        or args.serve)
        if not only_later:
            stream = build_stages(run)
            if args.decode:
                decode_stage(run, stream)
            if args.serve:
                serve_stage(run)
            if not (args.decode or args.serve or args.serve_sharded
                    or args.build_doc_sharded or args.build_pef_index):
                run.stages.say("build stages done; rerun with --decode on "
                               "the card")
        if args.serve_sharded:
            serve_sharded_stage(run)
        if args.build_doc_sharded:
            doc_sharded_stage(run)
        if args.build_pef_index:
            pef_index_stage(run)
    except BaseException as e:
        run.record["error"] = "".join(traceback.format_exception_only(
            type(e), e)).strip()
        raise
    finally:
        run.record["stages"] = run.stages.entries
        run.record["wall_s"] = time.perf_counter() - t_all
        run.record["peak_rss_gib"] = _vmhwm_gib()
        if run.device.type == "cuda":
            run.record["card_peak_bytes"] = max(
                [e.get("card_peak_bytes", 0) for e in run.stages.entries]
                + [torch.cuda.max_memory_allocated(run.device)])
        if args.record:
            os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                        exist_ok=True)
            with open(args.record, "w") as f:
                f.write(json.dumps(run.record) + "\n")
    return run.record


if __name__ == "__main__":
    main()
