#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's vroom gather decode on one NVIDIA card.

    python3 chip_smoke.py [--seed 2026] [--out FILE]

Run from the root of a checkout.  Phases, each fatal on failure:

1. card: the device's name and power limit; build the CUDA kernels
   (``dint_tpu_torch/kernels/csrc/*.cu``, nvcc for sm_90a) and the
   native host libraries (``native/*.cpp``, g++) side by side;
2. data: ``bench.py``'s synthetic collection (6000 lists, 4M docs,
   avg_len 5000) from ``--seed``, encoded as ``single_rect_dint`` and
   ``multi_packed_dint`` by the port's encoder, under ``.chip_smoke/``;
3. kernels: on the card, each class kernel (K1 gather32, K2 gather16,
   K3 zero) against its plain PyTorch twin under ``torch.equal``, at the
   bench image's shapes and on an edge-case batch, with salts 0, 1 and
   0xFFFFFFFF; each kernel's time (cold L2, CUDA events), its twin's
   time and its memory bound; the chained-run salt on the card against
   the twins' on the host for the bench image; a torch.profiler trace of 200 chained runs (device
   busy time and idle share a run);
4. main path: ``decode_stream(..., runs=2000, check_collection,
   device="cuda")`` for both types, exact over every list; launch counts
   reset just before and read just after.

Prints the stats records, the card line, one ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero with
no result line when there is no card or no checkout around it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    """Build the CUDA kernel library and the three native host libraries
    concurrently; return the kernel build's wall seconds."""
    from dint_tpu_torch.codecs import native
    from dint_tpu_torch.kernels import cuda_ext, planner_native
    from dint_tpu_torch.stats import native_stats

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0

    jobs = {
        "cuda kernels": cuda_ext.lib,
        "native encoder": native.get_lib,
        "native planner": planner_native.get_lib,
        "native stats": native_stats.get_lib,
    }
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        results = {k: f.result() for k, f in futs.items()}
    for k, (lib, secs) in results.items():
        if lib is None:
            fail(f"{k} failed to build")
        log(f"built {k} in {secs:.1f} s")
    return results["cuda kernels"][1]


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


def kernel_cases(engine):
    """{kernel name: [(kernel call, twin call, row count)]}: the bench
    image's class tensors first, then the edge batch; each call takes a
    salt tensor."""
    from dint_tpu_torch.kernels import decode_local as dl

    cls = {c.mode: c for c in engine._classes if c.rows}
    if sorted(cls) != [0, 16, 32]:
        fail(f"the image lacks a width class: it has {sorted(cls)}")
    v, t16, t32, n = edge_batch(engine.device)
    cases = {}
    for name, kern, plain, bench, edge in (
        ("K1_gather32", dl.gather32, dl.gather32_plain,
         [cls[32].vidx, cls[32].tab, cls[32].n], [v, t32, n]),
        ("K2_gather16", dl.gather16, dl.gather16_plain,
         [cls[16].vidx, cls[16].tab, cls[16].n], [v, t16, n]),
        ("K3_zero", dl.zero, dl.zero_plain, [cls[0].n], [n]),
    ):
        cases[name] = [
            (lambda s, a=args, k=kern: k(*a, s),
             lambda s, a=args, p=plain: p(*a, s), args[-1].shape[0])
            for args in (bench, edge)
        ]
    return cases


def check_kernels(engine):
    """Every kernel call equal to its twin for every salt; return
    {kernel name: max |kernel - twin|} over the u32 values."""
    import torch

    errs = {}
    for name, calls in kernel_cases(engine).items():
        worst = 0
        for kern, plain, _ in calls:
            for s in SALTS:
                st = torch.tensor([s], dtype=torch.int64,
                                  device=engine.device)
                got, want = kern(st), plain(st)
                if engine.device.type == "cuda":
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


def profile_chain(engine, runs: int, trace_path: str):
    """Where one chained run's time goes: ``runs`` runs of decode_chain
    under torch.profiler; the device's busy time is the union of the
    kernel, memset and memcpy intervals of the exported trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.decode_chain(runs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_chain(runs)
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
        "device_ms_per_run_by_name": {k: v / 1e3 / runs for k, v in top},
    }


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
    errs = check_kernels(dec.engine)
    log(f"kernels equal their twins on the card: {errs}")
    kernels = time_kernels(dec.engine, errs, kind)
    salt = chain_against_twins(dec.engine)
    log(f"chain salt on the card equals the host twins': {salt:#x}")
    prof = profile_chain(dec.engine, PROFILE_RUNS,
                         os.path.join(CACHE, "chain_trace.json"))
    print(json.dumps({"profile": prof}), flush=True)
    del dec
    torch.cuda.empty_cache()

    # 4. the main path, launches counted from zero
    recs, counts = drive_main_path(data, base, RUNS, "cuda")
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in counts.values())
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on the main path")
    for t in TYPES:
        r = recs[t]
        print(json.dumps({
            "type": t, "ints_x_sec": r["ints_x_sec"],
            "ns_x_int": r["ns_x_int"], "num_integers": r["num_integers"],
            "plan_bytes": r["plan_bytes"], "cold_start_s": r["cold_start_s"],
            "runs": r["runs"], "check": r["check"],
            "launches": counts[t], "device": kind, "nvidia_smi": smi,
        }), flush=True)
    summary = {"card": kind, "nvidia_smi": smi, "build_s": build_s,
               "kernels": kernels, "records": recs, "launches": counts,
               "chain_salt": salt, "profile": prof,
               "wall_s": time.perf_counter() - t_start}
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
