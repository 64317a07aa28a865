#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card: the vroom
gather decode, the whole bench (gather and ladder engines, store probe),
the one-hot kernel ablation and fused ranked query serving.

    python3 chip_smoke.py [--seed 2026] [--out FILE]

Run from the root of a checkout.  Phases, each fatal on failure:

1. card: the device's name and power limit; build the CUDA kernels
   (``dint_tpu_torch/kernels/csrc/*.cu``, one nvcc per source for
   sm_90a) and the native host libraries (``native/*.cpp``, g++), all
   side by side;
2. data: ``bench.py``'s synthetic collection (6000 lists, 4M docs,
   avg_len 5000) from ``--seed``, encoded as ``single_rect_dint`` and
   ``multi_packed_dint`` by the port's encoder, under ``.chip_smoke/``
   (``tools.bench``'s own create-or-load artifacts);
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
5. bench path: ``tools.bench.run`` on the card at full size: the gather
   and ladder legs of both types under 2000 chained runs (the ladder
   legs checked against the whole collection, the gather legs against a
   sample of lists, as ``bench.py`` does) and the store probe (K5);
   launch counts reset just before and read just after; the record is
   printed with the card in it; a torch.profiler trace of 50 chained
   ladder runs (device busy time against the bytes bound);
6. K5 against its plain version under ``torch.equal`` at the bench
   output size and at one tile, the same three salts; its time,
   ``fill_``'s time on the same bytes and the bound; the probe's chain
   salt on the card against the plain version's on the host;
7. ablation path: the per-unit plan of the single_rect stream,
   ``tools.kernel_ablate.run`` over it (every variant checked against
   ``gather_flat`` on the whole plan, then timed under the salted
   chain); launch counts reset just before and read just after; then K6
   and K7 against ``decode_gather_rows`` (their plain version) on 512
   plan rows and an edge batch, and against ``gather_flat`` on the whole
   plan, the same three salts, under ``torch.equal``; their times, the
   plain version's, and K1's on the same rows;
8. serve data: from the phase-2 collection, the ``.sizes`` file, a
   ``multi_packed_dint`` index (``tools.create_freq_index``), its wand
   data (``tools.create_wand_data``) and a 500-query log (2-5 distinct
   uniform terms a query, seed 7) plus four edge queries; each step
   timed;
9. serve path: the index loaded, ``TermDecoder(device="cuda")`` and a
   ``DeviceServingStore`` over every term (K1-K3 decode the index once),
   then the log through ``tools.queries``' device path: ``ranked_or``
   with k 10 (fused store, K4), one warm-up and 10 timed passes, and
   ``and``/``or`` counts; launch counts reset just before and read
   just after; K1-K3 against their twins under ``torch.equal`` on the
   class tensors of the docid and freq engines that path built;
10. K4 against its plain version under ``torch.equal`` at every bucket
    shape of the log and on an edge batch, each shape timed;
11. exactness: every term's docids and freqs decoded on the card equal
    the collection; every query's top-10 scores (and the scores of
    the returned docids) equal a numpy oracle over the collection files
    within rtol 2e-4, atol 1e-5; the and/or counts equal numpy's;
12. a torch.profiler trace of 3 serving passes.

Prints the stats records, the card line, one ``{"kernels": [...]}``
line (K1-K7) and, last, ``{"ok": true, "device": {...}}``.  Exits
non-zero with no result line when there is no card or no checkout
around it.
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
NUM_LISTS = 6000
NUM_DOCS = 4_000_000
AVG_LEN = 5000.0
SALTS = (0, 1, 0xFFFFFFFF)
RUNS = 2000  # chained runs a decode_stream times, as bench.py
PROFILE_RUNS = 200
LADDER_PROFILE_RUNS = 50
ABLATE_RUNS = 20  # chained runs a variant, tools/kernel_ablate's default
ONEHOT_PLAIN_ROWS = 512  # plan rows K6/K7 are held to their plain version on
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
DECODE_KERNELS = ("K1_gather32", "K2_gather16", "K3_zero")
SERVE_KERNELS = DECODE_KERNELS + ("K4_block_copy",)
BENCH_KERNELS = DECODE_KERNELS + ("K5_store_tile",)
ABLATE_KERNELS = DECODE_KERNELS + ("K6_onehot_block", "K7_onehot_group")
# Published H100 device-memory rates (NVIDIA data sheets), by card name.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))
# Integer ALU rate outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper white paper), in operations a second.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (data sheet)


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
    """Build every CUDA kernel library (one nvcc each) and the four
    native host libraries concurrently; return the slowest kernel
    build's wall seconds."""
    from dint_tpu_torch.codecs import native
    from dint_tpu_torch.kernels import cuda_ext, planner_native
    from dint_tpu_torch.query import native_host
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
        "native query host": native_host.get_lib,
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
    """Synthesize and encode the collection under ``root`` (a fresh
    ``tools.bench`` cache directory, so the bench path finds its
    artifacts made); return (collection basename, {type: (stream, dict
    file)})."""
    from dint_tpu_torch.tools import bench

    shutil.rmtree(root, ignore_errors=True)
    out = {}
    t0 = time.perf_counter()
    out["single_rect_dint"] = bench.build_artifacts(root, num_lists, num_docs,
                                                    avg_len, seed)
    log(f"synthesized and encoded single_rect_dint in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["multi_packed_dint"] = bench.build_multi_artifacts(root)
    log(f"encoded multi_packed_dint in {time.perf_counter() - t0:.1f} s")
    return os.path.join(root, "bench_collection"), out


def drop_plan_caches(root: str) -> None:
    """Remove the image and plan caches decode_stream left beside the
    streams, so that the next path plans its own (its cold start is
    then a plan, not a file read)."""
    for f in os.listdir(root):
        if ".plan." in f or ".image." in f:
            os.remove(os.path.join(root, f))


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


def u32_err(got, want) -> int:
    """max |got - want| over the u32 values of two int32 tensors."""
    import torch

    return int(((got.to(torch.int64) & MASK)
                - (want.to(torch.int64) & MASK)).abs().max())


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
                diff = u32_err(got, want)
                worst = max(worst, diff)
                if not torch.equal(got, want):
                    fail(f"{name} disagrees with its twin at salt {s:#x} "
                         f"(max abs err {diff})")
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
# The bench path (ladder legs, K5) and the ablation path (K6, K7)
# ---------------------------------------------------------------------------


def bound_entry(nbytes: int, t_ops_ms: float, card_name: str) -> dict:
    t_bytes = nbytes / hbm_rate(card_name) * 1e3
    return {"bound_ms": max(t_bytes, t_ops_ms),
            "bound_by": "bytes" if t_bytes >= t_ops_ms else "operations",
            "bytes": nbytes}


def drive_bench_path(seed: int):
    """Phase 5: every leg of tools.bench on the card, launches counted
    from zero; return (record, {leg: decode_stream record}, counts)."""
    from dint_tpu_torch.tools import bench

    drop_plan_caches(CACHE)
    reset_launch_counts()
    rec = bench.run(CACHE, "cuda", RUNS, NUM_LISTS, NUM_DOCS, AVG_LEN, seed)
    counts = launch_counts()
    legs = rec.pop("legs")
    for leg in ("ladder", "multi_ladder"):
        if legs[leg].get("check") != "ok":
            fail(f"bench {leg} leg: collection check did not pass")
    for name in BENCH_KERNELS:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the bench path")
    return rec, legs, counts


def profile_ladder(stream: str, dict_file: str, card_name: str,
                   trace_path: str):
    """Device-busy time of a chained ladder run against its bytes bound
    (the image read once, 4 B an int written once)."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import decode

    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary("single_rect_dint", dict_file).decode_view()
    dec = decode.LadderStreamDecoder(arena, meta, view, False, device="cuda")
    prof = profile_device(lambda: dec.engine.chain(LADDER_PROFILE_RUNS),
                          LADDER_PROFILE_RUNS, trace_path)
    nbytes = dec.plan_bytes + 4 * dec.engine.plan.total_ints
    prof.update({"image_bytes": dec.plan_bytes,
                 "classes": [[w, int(a0.shape[1]) * 128]
                             for _, w, a0, _ in dec.engine._dev],
                 "bound_ms_per_run": nbytes / hbm_rate(card_name) * 1e3})
    return prof


def check_k5(num_integers: int, card_name: str) -> dict:
    """Phase 6: K5 against its plain version at the bench output size
    and at one tile, its chain against the plain chain, and its times;
    returns its kernels-line entry."""
    import torch

    from dint_tpu_torch.kernels import store_probe as sp

    rows = sp.probe_rows(num_integers * 4)
    worst = 0
    for r in (rows, 1024):
        for s in SALTS:
            st = sp.salt_tensor(s, "cuda")
            got, want = sp.store_tile(st, r), sp.store_tile_plain(st, r)
            torch.cuda.synchronize()
            worst = max(worst, u32_err(got, want))
            if not torch.equal(got, want):
                fail(f"K5 disagrees with its plain version at {r} rows, "
                     f"salt {s:#x}")
    on_card = int(sp.probe_chain(2048, 1024, 3, torch.device("cuda")).item())
    on_host = int(sp.probe_chain(2048, 1024, 3, torch.device("cpu")).item())
    if on_card != on_host:
        fail(f"probe chain salt {on_card} on the card, {on_host} on the host")
    log(f"K5 equals its plain version at {rows} and 1024 rows; chain salt "
        f"{on_card & MASK:#x} on both")
    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    st = sp.salt_tensor(0x9E3779B9, "cuda")
    buf = torch.empty((rows, sp.ROW_LANES), dtype=torch.int32, device="cuda")
    entry = {
        "name": "K5_store_tile",
        "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/store_probe.cu",
        "replaces": "dint_tpu/kernels/store_probe.py:48 (kernel :37 in "
                    "_probe_fns :32)",
        "launches": 0,
        "max_abs_err": worst,
        "ms": time_ms(lambda: sp.store_tile(st, rows, out=buf), 50, flush),
        "plain_ms": time_ms(lambda: sp.store_tile_plain(st, rows), 5, flush),
        **bound_entry(rows * sp.ROW_LANES * 4 + 4,
                      4 * rows * sp.ROW_LANES / INT32_OPS_PER_S * 1e3,
                      card_name),
        "library_ms": time_ms(lambda: buf.fill_(7), 50, flush),
        "rows": rows,
    }
    log(f"K5 {entry['ms'] * 1e3:.1f} us, fill_ "
        f"{entry['library_ms'] * 1e3:.1f} us, bound "
        f"{entry['bound_ms'] * 1e3:.1f} us")
    return entry


def onehot_edge_batch(rows: int = 256, seed: int = 11):
    """K6/K7 inputs on the card that force the edge cases: table words
    with bit 31 set, n = 0, 1 and 256, and indices outside [0, 256)."""
    import torch

    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, 256, (rows, 256)).astype(np.int32)
    vidx[3, 5], vidx[4, 7], vidx[9, 0], vidx[9, 255] = 300, -1, 256, 2**31 - 1
    tab = rng.integers(0, 1 << 32, (rows, 256), dtype=np.uint64)
    tab[:, ::7] |= 0x80000000
    n = rng.integers(0, 257, rows).astype(np.int32)
    n[:10] = 256
    n[10], n[11] = 0, 1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
                 for a in (vidx, tab.astype(np.uint32).view(np.int32), n))


def ablate_phases(stream: str, dict_file: str, card_name: str):
    """Phase 7: the ablation as a user runs it (launches counted from
    zero), then K6 and K7 against their plain version and the flat
    gather, and their times.  Returns (ablation record, launch counts,
    [K6 entry, K7 entry])."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl
    from dint_tpu_torch.kernels import decode_pallas as dp
    from dint_tpu_torch.tools import kernel_ablate as ka

    t0 = time.perf_counter()
    plan = ka.plan_of_stream("single_rect_dint", stream, dict_file)
    log(f"ablation plan: {plan.rows} rows in {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    rec = ka.run(plan, ABLATE_RUNS, ka.VARIANTS, "cuda")
    counts = launch_counts()
    for name in ABLATE_KERNELS:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the ablation path")
    vi, v8, tbl, nn = ka.plan_arrays(plan, "cuda")
    R = int(vi.shape[0])
    kernels = (("K6_onehot_block", dp.decode_gather_pallas, 176,
                "_gather_block_kernel :48"),
               ("K7_onehot_group", dp.decode_gather_pallas_grid, 150,
                "_gather_group_kernel :103"))
    head = tuple(a[:ONEHOT_PLAIN_ROWS] for a in (vi, tbl, nn))
    errs = {name: 0 for name, *_ in kernels}
    for s in SALTS:
        st = torch.tensor([s], dtype=torch.int64, device="cuda")
        cases = [("plan head", head, dl.decode_gather_rows(*head, st)),
                 ("whole plan", (vi, tbl, nn), dl.gather_flat(v8, tbl, nn, st))]
        edge = onehot_edge_batch()
        cases.append(("edge batch", edge, dl.decode_gather_rows(*edge, st)))
        for name, kern, _, _ in kernels:
            for label, args, want in cases:
                got = kern(*args, st)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], u32_err(got, want))
                if not torch.equal(got, want):
                    fail(f"{name} disagrees on the {label} at salt {s:#x} "
                         f"(max abs err {errs[name]})")
        del cases
    log(f"K6 and K7 equal decode_gather_rows on {ONEHOT_PLAIN_ROWS} plan rows "
        f"and an edge batch, and gather_flat on all {R} rows")
    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    st = torch.tensor([0x9E3779B9], dtype=torch.int64, device="cuda")
    plain_ms = time_ms(lambda: dl.decode_gather_rows(vi, tbl, nn, st), 1,
                       flush)
    k1_ms = time_ms(lambda: dl.gather32(v8, tbl, nn, st), 20, flush)
    rate = hbm_rate(card_name)
    rec["same_rows"] = {
        "rows": R,
        "K1_gather32_ms": k1_ms,
        "K1_bound_ms": (R * (256 + 1024 + 1024 + 4) + 8) / rate * 1e3,
    }
    entries = []
    for name, kern, line, body in kernels:
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "dint_tpu_torch/kernels/csrc/onehot_gather.cu",
            "replaces": f"dint_tpu/kernels/decode_pallas.py:{line} ({body})",
            "launches": counts[name],
            "launches_by_path": {"ablate": counts[name]},
            "max_abs_err": errs[name],
            "ms": time_ms(lambda: kern(vi, tbl, nn, st), 10, flush),
            "plain_ms": plain_ms,
            **bound_entry(R * (3 * 1024 + 4) + 8,
                          2 * 4 * 256 * 256 * R / INT8_TENSOR_OPS_PER_S * 1e3,
                          card_name),
            "library_ms": None,
            "rows": R,
        })
        rec["same_rows"][name + "_ms"] = entries[-1]["ms"]
        log(f"{name} {entries[-1]['ms'] * 1e3:.1f} us on {R} rows (bound "
            f"{entries[-1]['bound_ms'] * 1e3:.1f} us, K1 {k1_ms * 1e3:.1f} us, "
            f"plain {plain_ms:.1f} ms)")
    return rec, counts, entries


# ---------------------------------------------------------------------------
# Serving: data, main path, K4, exactness
# ---------------------------------------------------------------------------


def kernel_modules():
    """The modules whose wrappers count their launches."""
    from dint_tpu_torch.kernels import decode_local, decode_pallas, store_probe
    from dint_tpu_torch.query import device_serve

    return decode_local, device_serve, store_probe, decode_pallas


def reset_launch_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def launch_counts():
    out = {}
    for m in kernel_modules():
        out.update(m.launch_counts())
    return out


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
    for name in SERVE_KERNELS:
        if counts[name] <= 0:
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
    drop_plan_caches(CACHE)
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

    # 5. the bench path (gather and ladder legs, the store probe),
    # launches counted from zero; the ladder's device-busy time
    bench_rec, bench_legs, bench_counts = drive_bench_path(args.seed)
    print(json.dumps({"bench": {**bench_rec, "launches": bench_counts,
                                "nvidia_smi": smi}}), flush=True)
    ladder_prof = profile_ladder(*data["single_rect_dint"], kind,
                                 os.path.join(CACHE, "ladder_trace.json"))
    print(json.dumps({"ladder_profile": ladder_prof}), flush=True)
    torch.cuda.empty_cache()

    # 6. K5 against its plain version, and its times
    k5 = check_k5(total, kind)
    k5["launches"] = bench_counts["K5_store_tile"]
    k5["launches_by_path"] = {"bench": k5["launches"]}

    # 7. the ablation path, launches counted from zero; K6 and K7
    # against their plain version and the flat gather, and their times
    ablate, ablate_counts, onehot = ablate_phases(*data["single_rect_dint"],
                                                  kind)
    print(json.dumps({"ablation": {**ablate, "launches": ablate_counts,
                                   "nvidia_smi": smi}}), flush=True)
    torch.cuda.empty_cache()

    # 8-12. serving: data, the serve path (launches counted from zero),
    # K4 against its plain version, exactness, profiler
    paths, data_s = make_serve_data(CACHE, base)
    serve = serve_phases(base, paths, kind,
                         os.path.join(CACHE, "serve_trace.json"))
    serve["data_s"] = data_s
    for k in kernels:
        by_path = {"decode": sum(c[k["name"]] for c in counts.values()),
                   "bench": bench_counts[k["name"]],
                   "ablate": ablate_counts[k["name"]],
                   "serve": serve["launches"][k["name"]]}
        if by_path["decode"] <= 0:
            fail(f"{k['name']} was never launched on the decode path")
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        k["max_abs_err"] = max(k["max_abs_err"],
                               serve["class_errs"][k["name"]])
    k4 = serve.pop("k4")
    k4["launches_by_path"] = {"serve": k4["launches"]}
    kernels += [k4, k5, *onehot]
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
               "chain_salt": salt, "profile": prof, "bench": bench_rec,
               "bench_legs": bench_legs, "bench_launches": bench_counts,
               "ladder_profile": ladder_prof, "ablation": ablate,
               "ablation_launches": ablate_counts, "serve": serve,
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
