#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two main paths on one NVIDIA card: the
vroom gather decode and fused ranked query serving.

    python3 chip_smoke.py [--seed 2026] [--out FILE]

Run from the root of a checkout.  Phases, each fatal on failure:

1. card: the device's name and power limit; build the CUDA kernels
   (``dint_tpu_torch/kernels/csrc/*.cu``, one nvcc per source for
   sm_90a) and the native host libraries (``native/*.cpp``, g++), all
   side by side;
2. data: ``bench.py``'s synthetic collection (6000 lists, 4M docs,
   avg_len 5000) from ``--seed``, encoded as ``single_rect_dint`` and
   ``multi_packed_dint`` by the port's encoder, under ``.chip_smoke/``;
3. kernels: on the card, each class kernel (K1 gather32, K2 gather16,
   K3 zero) against its plain PyTorch twin under ``torch.equal``, at the
   bench image's shapes and on an edge-case batch, with salts 0, 1 and
   0xFFFFFFFF; each kernel's time (cold L2, CUDA events), its twin's
   time and its memory bound; the chained-run salt on the card against
   the twins' on the host for the bench image; a torch.profiler trace
   of 200 chained runs (device busy time and idle share a run);
4. decode path: ``decode_stream(..., runs=2000, check_collection,
   device="cuda")`` for both types, exact over every list; launch counts
   reset just before and read just after;
5. serve data: from the phase-2 collection, the ``.sizes`` file, a
   ``multi_packed_dint`` index (``tools.create_freq_index``), its wand
   data (``tools.create_wand_data``) and a 500-query log (2-5 distinct
   uniform terms a query, seed 7) plus four edge queries; each step
   timed;
6. serve path: the index loaded, ``TermDecoder(device="cuda")`` and a
   ``DeviceServingStore`` over every term (K1-K3 decode the index once),
   then the log through ``tools.queries``' device path: ``ranked_or``
   with k 10 (fused store, K4), one warm-up and 10 timed passes, and
   ``and``/``or`` counts; launch counts reset just before and read
   just after; K1-K3 against their twins under ``torch.equal`` on the
   class tensors of the docid and freq engines that path built;
7. K4 against its plain version under ``torch.equal`` at every bucket
   shape of the log and on an edge batch, each shape timed;
8. exactness: every term's docids and freqs decoded on the card equal
   the collection; every query's top-10 scores (and the scores of
   the returned docids) equal a numpy oracle over the collection files
   within rtol 2e-4, atol 1e-5; the and/or counts equal numpy's;
9. a torch.profiler trace of 3 serving passes.

Prints the stats records, the card line, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero with
no result line when there is no card or no checkout around it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".chip_smoke")
TYPES = ("single_rect_dint", "multi_packed_dint")
DICT_KIND = {"single_rect_dint": "rectangular",
             "multi_packed_dint": "multi_packed"}
NUM_LISTS = 6000
NUM_DOCS = 4_000_000
AVG_LEN = 5000.0
SALTS = (0, 1, 0xFFFFFFFF)
RUNS = 2000  # chained runs a decode_stream times, as bench.py
PROFILE_RUNS = 200
MASK = 0xFFFFFFFF
SERVE_TYPE = "multi_packed_dint"  # the index of bench_artifacts/queries.json
SERVE_RUNS = 10  # timed serving passes after one warm-up
BOOL_RUNS = 3
QUERIES = 500
QUERY_SEED = 7  # scripts/ab_queries.py's query log
TOPK = 10
RTOL, ATOL = 2e-4, 1e-5  # tests/test_device_serve.py:87
PROFILE_PASSES = 3
K4_EDGE_G = (1, 7, 8193)
# Published H100 device-memory rates (NVIDIA data sheets), by card name.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))
# Integer ALU rate outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper white paper), in operations a second.
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    fail(f"no published memory rate for {name!r}")


def build_all():
    """Build every CUDA kernel library (one nvcc each) and the three
    native host libraries concurrently; return the slowest kernel
    build's wall seconds."""
    from dint_tpu_torch.codecs import native
    from dint_tpu_torch.kernels import cuda_ext, planner_native
    from dint_tpu_torch.stats import native_stats

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0

    jobs = {f"cuda {so}": (lambda so=so: cuda_ext.lib(so))
            for so in cuda_ext.LIBRARIES}
    jobs.update({
        "native encoder": native.get_lib,
        "native planner": planner_native.get_lib,
        "native stats": native_stats.get_lib,
    })
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        results = {k: f.result() for k, f in futs.items()}
    for k, (lib, secs) in results.items():
        if lib is None:
            fail(f"{k} failed to build")
        log(f"built {k} in {secs:.1f} s")
    return max(secs for k, (_, secs) in results.items()
               if k.startswith("cuda"))


def make_data(root: str, seed: int, num_lists: int, num_docs: int,
              avg_len: float):
    """Synthesize and encode the collection under ``root``; return
    (collection basename, {type: (stream, dict file)})."""
    from dint_tpu_torch.io import collection, synth
    from dint_tpu_torch.tools import encode

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    base = os.path.join(root, "bench_collection")
    t0 = time.perf_counter()
    docs, freqs = synth.make_collection(num_lists, num_docs, seed=seed,
                                        avg_len=avg_len)
    collection.write_freq_collection(base, docs, freqs, num_docs)
    log(f"synthesized {len(docs)} lists in {time.perf_counter() - t0:.1f} s")
    out = {}
    for t in TYPES:
        t0 = time.perf_counter()
        stream = os.path.join(root, f"bench.{t}.bin")
        encode.encode_collection(t, base + ".docs", stream, cache_dir=root)
        out[t] = (stream, os.path.join(
            root, f"dict.bench_collection.docs.{DICT_KIND[t]}.DSF-65536-16"))
        log(f"encoded {t} in {time.perf_counter() - t0:.1f} s")
    return base, out


def load_decoder(stream: str, dict_file: str, type_name: str, device):
    """A StreamDecoder over ``stream`` that plans its own image (no
    cache file is read or written)."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import decode

    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary(type_name, dict_file).decode_view()
    return decode.StreamDecoder(arena, meta, view,
                                type_name.startswith("multi"), device=device)


def edge_batch(device, rows=67, seed=7):
    """Rows that force the kernels' edge cases: n = 0 and n = N_OUT, a
    row count that is no multiple of a block's rows, indices with bit 7
    set, table words >= 2^31 and u16 words with both halves set."""
    import numpy as np
    import torch

    from dint_tpu_torch.kernels.decode_local import N_OUT

    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, 256, (rows, N_OUT)).astype(np.uint8)
    vidx[1] = 255
    vidx[2] = np.arange(N_OUT) % 256 | 0x80
    n = rng.integers(0, N_OUT + 1, rows).astype(np.int32)
    n[:4] = (0, N_OUT, N_OUT, 1)
    tab32 = rng.integers(0, 1 << 32, (rows, 256), dtype=np.uint64)
    tab32[:, ::7] |= 0x80000000
    tab16 = rng.integers(0, 1 << 32, (rows, 128), dtype=np.uint64)
    tab16[:, ::3] |= 0x80008000

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (up(vidx), up(tab16.astype(np.uint32).view(np.int32)),
            up(tab32.astype(np.uint32).view(np.int32)), up(n))


def class_kernels():
    """[(width class, kernel name, kernel, twin)], K1 first."""
    from dint_tpu_torch.kernels import decode_local as dl

    return [(32, "K1_gather32", dl.gather32, dl.gather32_plain),
            (16, "K2_gather16", dl.gather16, dl.gather16_plain),
            (0, "K3_zero", dl.zero, dl.zero_plain)]


def class_cases(engine, cases=None):
    """Add to ``cases`` ({kernel name: [(kernel call, twin call, row
    count)]}, each call taking a salt tensor) one case for each width
    class that ``engine`` (an image or a per-unit engine) holds rows of,
    on its own class tensors; return ``cases``."""
    cases = {} if cases is None else cases
    cls = {c.mode: c for c in engine._classes if c.rows}
    for mode, name, kern, plain in class_kernels():
        if mode not in cls:
            continue
        c = cls[mode]
        args = [c.vidx, c.tab, c.n] if mode else [c.n]
        cases.setdefault(name, []).append(
            (lambda s, a=args, k=kern: k(*a, s),
             lambda s, a=args, p=plain: p(*a, s), c.rows))
    return cases


def kernel_cases(engine):
    """The bench image's class cases first, then the edge batch."""
    cases = class_cases(engine)
    if len(cases) != 3:
        fail(f"the image lacks a width class: it has {sorted(cases)}")
    v, t16, t32, n = edge_batch(engine.device)
    edge = {"K1_gather32": [v, t32, n], "K2_gather16": [v, t16, n],
            "K3_zero": [n]}
    for _, name, kern, plain in class_kernels():
        args = edge[name]
        cases[name].append((lambda s, a=args, k=kern: k(*a, s),
                            lambda s, a=args, p=plain: p(*a, s),
                            args[-1].shape[0]))
    return cases


def check_kernels(cases):
    """Every kernel call of ``cases`` equal to its twin on the card for
    every salt; return {kernel name: max |kernel - twin|} over the u32
    values."""
    import torch

    errs = {}
    for name, calls in cases.items():
        worst = 0
        for kern, plain, _ in calls:
            for s in SALTS:
                st = torch.tensor([s], dtype=torch.int64, device="cuda")
                got, want = kern(st), plain(st)
                torch.cuda.synchronize()
                diff = ((got.to(torch.int64) & MASK)
                        - (want.to(torch.int64) & MASK)).abs().max()
                worst = max(worst, int(diff))
                if not torch.equal(got, want):
                    fail(f"{name} disagrees with its twin at salt {s:#x} "
                         f"(max abs err {int(diff)})")
        errs[name] = worst
    return errs


def kernel_bytes_ops(name: str, rows: int, n_out: int):
    """(bytes moved, integer operations) of one call: each input read
    once, the output written once; ops per output lane as in the
    kernel body."""
    out, n_b, salt_b = rows * n_out * 4, rows * 4, 8
    if name == "K1_gather32":
        return rows * n_out + rows * 1024 + n_b + salt_b + out, 4 * rows * n_out
    if name == "K2_gather16":
        return rows * n_out + rows * 512 + n_b + salt_b + out, 5 * rows * n_out
    return n_b + salt_b + out, 2 * rows * n_out


def time_ms(fn, iters: int, flush) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` launches, each
    timed by CUDA events after the L2 cache was flushed by reading
    ``flush`` (a read leaves no dirty lines to write back).  The card
    first sleeps ~25 ms so that the host has queued every launch before
    the card reaches it: the events then time the card's work, not the
    host's launch latency."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(iters):
        flush.amax()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in pairs)
    return ts[len(ts) // 2]


def time_kernels(engine, errs, card_name):
    """One kernels-line entry per kernel at the bench image's shapes."""
    import torch

    from dint_tpu_torch.kernels.decode_local import N_OUT

    rate = hbm_rate(card_name)
    flush = torch.zeros(24 << 20, dtype=torch.int32, device=engine.device)
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device=engine.device)
    rows_of = {}
    out = []
    srcs = {
        "K1_gather32": ("_gather32_body", 944),
        "K2_gather16": ("_gather16_body", 914),
        "K3_zero": ("_zero_body", 983),
    }
    for name, calls in kernel_cases(engine).items():
        kern, plain, rows = calls[0]  # the bench image's class
        rows_of[name] = rows
        ms = time_ms(lambda: kern(salt), 50, flush)
        plain_ms = time_ms(lambda: plain(salt), 5, flush)
        nbytes, ops = kernel_bytes_ops(name, rows, N_OUT)
        t_bytes, t_ops = nbytes / rate * 1e3, ops / INT32_OPS_PER_S * 1e3
        fn, line = srcs[name]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "dint_tpu_torch/kernels/csrc/decode_gather.cu",
            "replaces": f"dint_tpu/kernels/decode_local.py:{line} ({fn})",
            "launches": 0,
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "rows": rows,
            "bytes": nbytes,
        })
    del flush
    return out


def drive_main_path(data, base, runs: int, device):
    """decode_stream for both types with the full collection check;
    return ({type: record}, {type: launch counts})."""
    from dint_tpu_torch.kernels import decode_local as dl
    from dint_tpu_torch.tools import decode

    recs, counts = {}, {}
    for t in TYPES:
        stream, dict_file = data[t]
        dl.reset_launch_counts()
        rec = decode.decode_stream(t, stream, dict_file, runs=runs,
                                   check_collection=base + ".docs",
                                   device=device)
        counts[t] = dl.launch_counts()
        if rec.get("check") != "ok":
            fail(f"{t}: collection check did not pass")
        recs[t] = rec
    return recs, counts


def chain_against_twins(engine, runs=3) -> int:
    """decode_chain's final salt on the card equals the twins' on the
    host for the same image; return it."""
    from dint_tpu_torch.kernels import decode_local as dl

    on_card = int(engine.decode_chain(runs).item())
    on_host = int(dl.ImageDecodeEngine(engine.image, device="cpu")
                  .decode_chain(runs).item())
    if on_card != on_host:
        fail(f"chain salt {on_card:#x} on the card, {on_host:#x} on the host")
    return on_card


def profile_device(fn, runs: int, trace_path: str):
    """Where the time of ``fn()`` (``runs`` runs' worth of work) goes:
    one warm-up call, then one call under torch.profiler; the device's
    busy time is the union of the kernel, memset and memcpy intervals of
    the exported trace, the idle share is measured over the host's wall
    time of the call (which ends in a synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    if not dev:
        return {"runs": runs, "wall_ms_per_run": wall * 1e3 / runs,
                "device_busy_ms_per_run": "not measured"}
    busy, end = 0.0, dev[0][0]
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        key = name[:60]
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    span = dev[-1][1] - dev[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "runs": runs,
        "wall_ms_per_run": wall * 1e3 / runs,
        "device_span_ms_per_run": span / 1e3 / runs,
        "device_busy_ms_per_run": busy / 1e3 / runs,
        "device_idle_share": 1.0 - busy / span,
        "device_idle_share_of_wall": 1.0 - busy / 1e6 / wall,
        "device_ms_per_run_by_name": {k: v / 1e3 / runs for k, v in top},
    }


# ---------------------------------------------------------------------------
# Serving: data, main path, K4, exactness
# ---------------------------------------------------------------------------


def reset_launch_counts() -> None:
    from dint_tpu_torch.kernels import decode_local as dl
    from dint_tpu_torch.query import device_serve as ds

    dl.reset_launch_counts()
    ds.reset_launch_counts()


def launch_counts():
    from dint_tpu_torch.kernels import decode_local as dl
    from dint_tpu_torch.query import device_serve as ds

    return {**dl.launch_counts(), **ds.launch_counts()}


def read_collection(base: str):
    """(docs lists, freqs lists, num_docs) straight from the files."""
    from dint_tpu_torch.io import collection

    view = collection.open_freq_collection(base)
    docs, freqs = [], []
    for d, f in view:
        docs.append(np.asarray(d))
        freqs.append(np.asarray(f))
    return docs, freqs, view.num_docs


def write_query_log(path: str, lengths, seed: int = QUERY_SEED) -> list:
    """``QUERIES`` lines of 2-5 distinct uniform-random terms
    (scripts/ab_queries.py:142-147), then four edge queries: one term
    alone, one term repeated, a term with an empty list (the shortest
    list where the collection has none) beside another, and the longest
    list alone.  Returns the queries."""
    rng = np.random.default_rng(seed)
    num_lists = len(lengths)
    qs = []
    for _ in range(QUERIES):
        n = int(rng.integers(2, 6))
        qs.append([int(t) for t in rng.choice(num_lists, size=n,
                                               replace=False)])
    lengths = np.asarray(lengths)
    order = np.argsort(lengths, kind="stable")
    mid, longest = int(order[num_lists // 2]), int(order[-1])
    empty = np.flatnonzero(lengths == 0)
    low = int(empty[0]) if empty.size else int(order[0])
    qs += [[mid], [mid, mid], [low, mid], [longest]]
    with open(path, "w") as f:
        for q in qs:
            f.write(" ".join(map(str, q)) + "\n")
    return qs


def make_serve_data(root: str, base: str):
    """Phase 5: the ``.sizes`` file, the saved index, its wand data and
    the query log under ``root``; return (paths, {step: seconds})."""
    from dint_tpu_torch.io import collection, synth
    from dint_tpu_torch.tools import create_freq_index, create_wand_data

    times = {}
    t0 = time.perf_counter()
    docs, freqs, num_docs = read_collection(base)
    collection.write_sizes_file(
        base, synth.doc_sizes_from_lists(docs, freqs, num_docs))
    times["sizes_s"] = time.perf_counter() - t0
    idx_path = os.path.join(root, f"serve.{SERVE_TYPE}.npz")
    t0 = time.perf_counter()
    create_freq_index.main([SERVE_TYPE, base, idx_path, "--cache-dir", root])
    times["build_index_s"] = time.perf_counter() - t0
    wand = os.path.join(root, "serve.wand")
    t0 = time.perf_counter()
    create_wand_data.main([base, wand])
    times["wand_data_s"] = time.perf_counter() - t0
    qfile = os.path.join(root, "queries.txt")
    t0 = time.perf_counter()
    write_query_log(qfile, [d.shape[0] for d in docs])
    times["query_log_s"] = time.perf_counter() - t0
    for k, v in times.items():
        log(f"serve data: {k} {v:.2f}")
    return (idx_path, wand + ".npz", qfile), times


@contextlib.contextmanager
def keep_engines(kept: list):
    """Inside the block, every LocalDecodeEngine built (TermDecoder
    builds one a decoded batch and drops it) is also appended to
    ``kept``, so that its class tensors, the inputs K1-K3 had on the
    serve path, can be checked afterwards."""
    from dint_tpu_torch.kernels import decode_local as dl

    base = dl.LocalDecodeEngine

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    dl.LocalDecodeEngine = Kept
    try:
        yield kept
    finally:
        dl.LocalDecodeEngine = base


def drive_serve_path(paths, runs: int, bool_runs: int):
    """Phase 6, the serving main path as a user drives it on the card:
    load the index, wand data and log; decode the whole index once into
    a DeviceServingStore; run the log through tools.queries' device path
    (ranked_or, then and/or).  Returns (state, {op: record},
    {step: seconds})."""
    from dint_tpu_torch.index.dint_index import DintIndex
    from dint_tpu_torch.query import boolean, device_serve, ranked
    from dint_tpu_torch.query.term_decode import TermDecoder
    from dint_tpu_torch.tools import queries as qtool

    idx_path, wand_path, qfile = paths
    times = {}
    t0 = time.perf_counter()
    index = DintIndex.load(idx_path)
    wdata = ranked.WandData.load(wand_path)
    qs = boolean.parse_query_log(qfile)
    times["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    index.ensure_docs_end()
    times["ensure_docs_end_s"] = time.perf_counter() - t0
    dec = TermDecoder(index, device="cuda")
    t0 = time.perf_counter()
    store = device_serve.DeviceServingStore(index, dec, wdata)
    times["store_build_s"] = time.perf_counter() - t0
    times.update({f"store_{k}": v for k, v in store.build_timings.items()})
    times.update({f"term_decoder_{k}_s": v for k, v in dec.timings.items()})
    recs = {}
    for op, r in (("ranked_or", runs), ("and", bool_runs), ("or", bool_runs)):
        stats, shape, extra = qtool.run_op_device(index, dec, wdata, qs, op,
                                                  r, TOPK, store=store)
        recs[op] = {"type": op, **stats, "runs": r,
                    "queries_per_s": 1e6 / stats["avg"],
                    "batch_shape": "x".join(map(str, shape)), **extra}
    for k, v in times.items():
        log(f"serve path: {k} {v:.2f}")
    state = {"index": index, "wdata": wdata, "queries": qs, "decoder": dec,
             "store": store}
    return state, recs, times


def k4_cases(store, dev_buckets, seed: int = 5):
    """(name, blk, qw) K4 inputs on the card: every bucket of the log,
    then edge batches of G 1, 7 and 8193 with PAD-row ids, ids outside
    [0, NB) (which both versions read as the PAD row), qw 0, negative
    and subnormal."""
    import torch

    cases = [(f"bucket P={P} G={blk.shape[0]}", blk, qw)
             for P, _, blk, qw, _ in dev_buckets]
    rng = np.random.default_rng(seed)
    NB = store.NB
    bad = np.array([-1, NB, 2**31 - 1, -2**31], np.int32)
    for G in K4_EDGE_G:
        blk = rng.integers(0, NB, G).astype(np.int32)
        blk[::3] = NB - 1
        out = blk[4::11]
        out[:] = bad[np.arange(out.shape[0]) % bad.shape[0]]
        qw = (rng.standard_normal(G) * 4).astype(np.float32)
        qw[::5] = 0.0
        qw[1::4] = -np.abs(qw[1::4])
        qw[2::6] = np.float32(1e-40)  # subnormal
        cases.append((f"edge G={G}", torch.from_numpy(blk).to(store.device),
                      torch.from_numpy(qw).to(store.device)))
    return cases


def check_k4(store, cases) -> float:
    """K4 equal to its plain version (torch.equal, both outputs) on
    every case; return the max abs difference (0)."""
    import torch

    from dint_tpu_torch.query import device_serve as ds

    worst = 0.0
    for name, blk, qw in cases:
        d, s = ds.block_copy(blk, qw, store._dstore, store._wstore)
        pd, ps = ds.block_copy_plain(blk, qw, store._dstore, store._wstore)
        if d.is_cuda:
            torch.cuda.synchronize()
        err = max(float((d.to(torch.int64) - pd.to(torch.int64)).abs().max()),
                  float((s - ps).abs().max()))
        worst = max(worst, err)
        if not (torch.equal(d, pd) and torch.equal(s, ps)):
            fail(f"K4 disagrees with its plain version at {name} "
                 f"(max abs err {err})")
    return worst


def time_k4(store, dev_buckets, card_name: str):
    """Per bucket shape of the log: K4's, the plain version's and the
    index_select pair's median time over 50 calls (L2 flushed), and the
    bytes bound of this bucket's ids."""
    import torch

    from dint_tpu_torch.query import device_serve as ds

    rate = hbm_rate(card_name)
    flush = torch.zeros(24 << 20, dtype=torch.int32, device=store.device)
    dst, wst = store._dstore, store._wstore
    out = []
    for P, idxs, blk, qw, _ in dev_buckets:
        G = int(blk.shape[0])
        # the distinct store rows are read once (padding tiles all name
        # the PAD row), every output row is written, blk and qw read
        distinct = int(torch.unique(blk).numel())
        nbytes = distinct * 2 * 1024 + G * 2 * 1024 + 8 * G
        out.append({
            "P": P, "G": G, "rows": len(idxs), "distinct_rows": distinct,
            "ms": time_ms(lambda: ds.block_copy(blk, qw, dst, wst), 50,
                          flush),
            "plain_ms": time_ms(
                lambda: ds.block_copy_plain(blk, qw, dst, wst), 50, flush),
            "library_ms": time_ms(
                lambda: (torch.index_select(dst, 0, blk),
                         torch.index_select(wst, 0, blk) * qw[:, None]),
                50, flush),
            "bound_ms": nbytes / rate * 1e3,
            "bytes": nbytes,
        })
    del flush
    return out


def oracle_topk(docs, freqs, norm, num_docs, q):
    """Top-k BM25 union scores of ``q`` from the raw lists: (scores
    desc, unique docids, per-docid sums)."""
    from dint_tpu_torch.query import ranked

    qf = {}
    for t in q:
        qf[t] = qf.get(t, 0) + 1
    ds, ss = [], []
    for t in sorted(qf):
        d = docs[t].astype(np.int64)
        w = np.float32(ranked.query_term_weight(qf[t], d.shape[0], num_docs))
        ds.append(d)
        ss.append(w * ranked.doc_term_weight(freqs[t], norm[d]))
    d = np.concatenate(ds)
    s = np.concatenate(ss).astype(np.float32)
    if d.size == 0:
        return np.zeros(0, np.float32), d, s
    order = np.argsort(d, kind="stable")
    d, s = d[order], s[order]
    starts = np.flatnonzero(np.concatenate([[True], d[1:] != d[:-1]]))
    sums = np.add.reduceat(s, starts)
    return np.sort(sums)[::-1][:TOPK].astype(np.float32), d[starts], sums


def check_serving(base: str, state):
    """Phase 8: decoded lists, ranked top-k and boolean counts against
    the collection files; returns a summary.  The lists checked are
    every term's, as the store build decoded them on the card (the
    decoder's cache)."""
    from dint_tpu_torch.query import device_batch

    docs, freqs, num_docs = read_collection(base)
    qs, dec, store = state["queries"], state["decoder"], state["store"]
    terms = list(range(len(docs)))
    if len(dec._doc_cache) != len(docs) or len(dec._freq_cache) != len(docs):
        fail("the store build did not decode every term")
    got_d, got_f = dec.decode_docids(terms), dec.decode_freqs(terms)
    bad = [t for t in terms if not (np.array_equal(got_d[t], docs[t])
                                    and np.array_equal(got_f[t], freqs[t]))]
    if bad:
        fail(f"terms {bad[:10]} decode wrong on the card")
    out_s, out_d, _ = store.ranked_topk(qs, k=TOPK, prune=False)
    norm = np.asarray(state["wdata"].norm_lens, np.float32)
    worst = 0.0
    for i, q in enumerate(qs):
        want, ud, sums = oracle_topk(docs, freqs, norm, num_docs, q)
        got = out_s[i]
        if got.shape != want.shape or not np.allclose(got, want, rtol=RTOL,
                                                      atol=ATOL):
            fail(f"query {i} {q}: scores {got} != oracle {want}")
        pos = np.searchsorted(ud, out_d[i].astype(np.int64))
        pos = np.minimum(pos, max(ud.shape[0] - 1, 0))
        if got.size and not (np.array_equal(ud[pos], out_d[i])
                             and np.allclose(sums[pos], got, rtol=RTOL,
                                             atol=ATOL)):
            fail(f"query {i} {q}: returned docids do not carry their scores")
        if want.size:
            worst = max(worst, float(np.max(np.abs(got - want)
                                             / np.maximum(np.abs(want),
                                                          1e-30))))
    counts = {}
    for op in ("and", "or"):
        got = device_batch.boolean_count_batch(dec, qs, op)
        for i, q in enumerate(qs):
            lists = [docs[t] for t in sorted(set(q))]
            if op == "and":
                want = lists[0]
                for x in lists[1:]:
                    want = np.intersect1d(want, x)
            else:
                want = np.unique(np.concatenate(lists))
            if int(got[i]) != want.shape[0]:
                fail(f"{op} query {i} {q}: {int(got[i])} != {want.shape[0]}")
        counts[op] = int(got.sum())
    return {"queries": len(qs), "terms_checked": len(terms),
            "max_rel_score_err": worst, "total_results": counts}


def check_serve_classes(kept, counts):
    """K1-K3 against their twins on the class tensors of the engines the
    serve path built (the docid and freq class splits); every class
    kernel launched there must have been checked.  Returns {kernel
    name: max abs err}."""
    cases = {}
    for e in kept:
        class_cases(e, cases)
        log("serve engine classes: " + ", ".join(
            f"{c.mode}: {c.rows} rows" for c in e._classes if c.rows))
    for _, name, _, _ in class_kernels():
        if counts[name] and name not in cases:
            fail(f"{name} ran on the serve path but no class was kept")
    return check_kernels(cases)


def serve_phases(base: str, paths, card_name: str, trace_path: str):
    """Phases 6-9 on the card: the serving main path with launches
    counted from zero, K1-K3 against their twins on that path's class
    tensors, K4 against its plain version and its times, exactness, and
    the profiler.  Returns a summary with the launch counts, the serve
    path's K1-K3 errors, K4's kernels-line entry and the records."""
    import torch

    kept = []
    reset_launch_counts()
    with keep_engines(kept):
        state, recs, times = drive_serve_path(paths, SERVE_RUNS, BOOL_RUNS)
    counts = launch_counts()
    log(f"serve path launches: {counts}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"{name} was never launched on the serve path")
    class_errs = check_serve_classes(kept, counts)
    log(f"K1-K3 equal their twins on the serve path's classes: {class_errs}")
    del kept
    torch.cuda.empty_cache()
    store = state["store"]
    buckets, _, _ = store._batch_metadata(state["queries"], TOPK)
    dev_buckets, _ = store.upload(buckets)
    if counts["K4_block_copy"] != len(buckets) * (SERVE_RUNS + 1):
        fail(f"K4 launched {counts['K4_block_copy']} times, not once per "
             f"bucket ({len(buckets)}) per pass ({SERVE_RUNS + 1})")
    k4_err = check_k4(store, k4_cases(store, dev_buckets))
    log(f"K4 equals its plain version at {len(dev_buckets)} bucket shapes "
        f"and {len(K4_EDGE_G)} edge batches")
    exact = check_serving(base, state)
    log(f"serving exact: {exact}")
    shapes = time_k4(store, dev_buckets, card_name)
    for sh in shapes:
        log(f"K4 P={sh['P']} G={sh['G']} ({sh['distinct_rows']} distinct "
            f"rows): {sh['ms'] * 1e3:.1f} us, plain pair "
            f"{sh['plain_ms'] * 1e3:.1f} us, bound "
            f"{sh['bound_ms'] * 1e3:.1f} us")
    nbytes = sum(s["bytes"] for s in shapes)
    t_ops = sum(s["G"] for s in shapes) * 256 / 67e12 * 1e3
    bound = sum(s["bound_ms"] for s in shapes)
    k4 = {
        "name": "K4_block_copy",
        "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/serve_gather.cu",
        "replaces": "dint_tpu/query/device_serve.py:124 (copy_kernel "
                    ":90 in _gather_fn :62)",
        "launches": counts["K4_block_copy"],
        "max_abs_err": k4_err,
        "ms": sum(s["ms"] for s in shapes),
        "plain_ms": sum(s["plain_ms"] for s in shapes),
        "bound_ms": max(bound, t_ops),
        "bound_by": "bytes" if bound >= t_ops else "operations",
        "library_ms": sum(s["library_ms"] for s in shapes),
        "bytes": nbytes,
        "shapes": shapes,
    }
    prof = profile_device(
        lambda: [store.serve(dev_buckets, TOPK)
                 for _ in range(PROFILE_PASSES)],
        PROFILE_PASSES, trace_path)
    torch.cuda.synchronize()
    return {"records": recs, "host_s": times, "launches": counts,
            "class_errs": class_errs, "exact": exact,
            "store_bytes": store.store_bytes, "store_rows": store.NB,
            "k4": k4, "profile": prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--out", help="also write the full summary JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not os.path.isdir(os.path.join(REPO, "dint_tpu_torch")):
        fail(f"no dint_tpu_torch package beside {__file__}: run it from the "
             "root of a checkout")
    sys.path.insert(0, REPO)

    t_start = time.perf_counter()
    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    log(f"card: {kind} | nvidia-smi: {smi}")
    build_s = build_all()

    # 2. data
    base, data = make_data(CACHE, args.seed, NUM_LISTS, NUM_DOCS, AVG_LEN)

    # 3. kernels against their twins, and their times
    dec = load_decoder(*data["single_rect_dint"], "single_rect_dint", "cuda")
    img = dec.engine.image
    total = img.total_ints()
    want = sum(int(n) for n in dec.meta.n)
    if total != want:
        fail(f"bench image holds {total} ints, the collection {want}")
    log(f"image: {total} ints; rows zero {img.n0.shape[0]}, u16 "
        f"{img.n16.shape[0]}, i32 {img.n32.shape[0]}; "
        f"{img.device_bytes()} B")
    errs = check_kernels(kernel_cases(dec.engine))
    log(f"kernels equal their twins on the card: {errs}")
    kernels = time_kernels(dec.engine, errs, kind)
    salt = chain_against_twins(dec.engine)
    log(f"chain salt on the card equals the host twins': {salt:#x}")
    prof = profile_device(lambda: dec.engine.decode_chain(PROFILE_RUNS),
                          PROFILE_RUNS, os.path.join(CACHE, "chain_trace.json"))
    print(json.dumps({"profile": prof}), flush=True)
    del dec
    torch.cuda.empty_cache()

    # 4. the decode path, launches counted from zero
    recs, counts = drive_main_path(data, base, RUNS, "cuda")
    for t in TYPES:
        r = recs[t]
        print(json.dumps({
            "type": t, "ints_x_sec": r["ints_x_sec"],
            "ns_x_int": r["ns_x_int"], "num_integers": r["num_integers"],
            "plan_bytes": r["plan_bytes"], "cold_start_s": r["cold_start_s"],
            "runs": r["runs"], "check": r["check"],
            "launches": counts[t], "device": kind, "nvidia_smi": smi,
        }), flush=True)
    torch.cuda.empty_cache()

    # 5-9. serving: data, the serve path (launches counted from zero),
    # K4 against its plain version, exactness, profiler
    paths, data_s = make_serve_data(CACHE, base)
    serve = serve_phases(base, paths, kind,
                         os.path.join(CACHE, "serve_trace.json"))
    serve["data_s"] = data_s
    for k in kernels:
        by_path = {"decode": sum(c[k["name"]] for c in counts.values()),
                   "serve": serve["launches"][k["name"]]}
        if by_path["decode"] <= 0:
            fail(f"{k['name']} was never launched on the decode path")
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["max_abs_err"] = max(k["max_abs_err"],
                               serve["class_errs"][k["name"]])
    k4 = serve.pop("k4")
    k4["launches_by_path"] = {"serve": k4["launches"]}
    kernels.append(k4)
    ranked = serve["records"]["ranked_or"]
    print(json.dumps({"serve": {
        "type": "ranked_or", "k": TOPK, "queries": serve["exact"]["queries"],
        **{key: ranked[key] for key in ("avg", "q50", "q90", "q95",
                                        "queries_per_s", "runs",
                                        "batch_shape", "buckets",
                                        "single_term_queries",
                                        "metadata_upload_bytes",
                                        "store_bytes", "store_build_s")},
        "exact": serve["exact"], "launches": serve["launches"],
        "host_s": {**data_s, **serve["host_s"]},
        "and": {key: serve["records"]["and"][key]
                for key in ("avg", "q50", "total_results")},
        "or": {key: serve["records"]["or"][key]
               for key in ("avg", "q50", "total_results")},
        "device": kind, "nvidia_smi": smi,
    }}), flush=True)
    print(json.dumps({"serve_profile": serve["profile"]}), flush=True)
    summary = {"card": kind, "nvidia_smi": smi, "build_s": build_s,
               "kernels": kernels, "records": recs, "launches": counts,
               "chain_salt": salt, "profile": prof, "serve": serve,
               "wall_s": time.perf_counter() - t_start}
    log(f"done in {summary['wall_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
