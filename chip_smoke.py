#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card: the vroom
gather decode, the whole bench (gather and ladder engines, store probe),
the one-hot kernel ablation, fused ranked query serving, the raw
chain-scan engine, the eleven zoo list types, the sharded steps and
serving over torch.distributed, the statistics merge, the multi-rank
dry run, the EF and block index families (device EF decode, block-codec
serving through K4), the native cursor engine, the chained decode of
packed per-unit plans, the last tools (check_encoded_data,
check_index, pair_wise_intersect, dict_perf_test) with the numpy coders
of the batch encoder, the scale pipeline (tools.scale_test) and the
single-device entry.

    python3 chip_smoke.py [--seed 2026] [--out FILE]

Run from the root of a checkout.  Phases, each fatal on failure:

1. card: the device's name and power limit; build the CUDA kernels
   (``dint_tpu_torch/kernels/csrc/*.cu``, eight sources, one nvcc each for
   sm_90a) and the native host libraries (``native/*.cpp``, g++), all
   side by side;
2. data: ``bench.py``'s synthetic collection (6000 lists, 4M docs,
   avg_len 5000) from ``--seed``, encoded as ``single_rect_dint`` and
   ``multi_packed_dint`` by the port's encoder, under ``.chip_smoke/``
   (``tools.bench``'s own create-or-load artifacts);
3. kernels: on the card, each class kernel (K1 gather32, K2 gather16,
   K3 zero) against its plain PyTorch twin under ``torch.equal``, at the
   bench image's shapes and on an edge-case batch, with salts 0, 1 and
   0xFFFFFFFF; the fused class launch (one grid over the three classes,
   what the engines run) against its plain version in both flags (raw,
   exact) on the bench image's classes, trimmed as the engine keeps them
   and as padded triples, and on edge batches with an empty class and
   row counts that are no multiple of a block's rows, padded and
   trimmed; the classes at odds of ``fused_refused_cases`` refused with
   no launch; timed in turns (cold L2, CUDA events): K1 alone, an empty
   grid of K1's shape (the floor a launch of its own pays), the fused
   launch trimmed and padded, the three stand-alone launches back to
   back, K2 and K3 alone, each with its twin's time and its memory
   bound (the fused launch's from the trimmed bytes); the fused launch's
   two forms chained as the benchmark runs it and on serving-sized
   heads (37/301/19 and 3/40/2 rows); the chained-run salt on
   the card against the twins' on the host for the bench image (the
   fused launches that walked, ``decode_classes.walked``: those of more
   row tiles than the card holds blocks at once, and those that read a
   class trimmed, ``decode_classes.trimmed``, counted beside the
   launches on every path); a
   torch.profiler trace of 200 chained runs (device busy time and idle
   share a run); K2 and K3 also timed beside their library calls
   (``torch.gather`` on the int16 view of K2's table, ``fill_`` over K3's
   output bytes); K3 alone at every n_out (128-1024) against its twin
   for row counts that are no multiple of a block, with a guard row after
   its output that it must leave as it was; the zero class alone in the
   fused launch timed against its bytes bound; X1, the fused
   ladder unpack, against its plain version
   under ``torch.equal`` in both layouts (the bench ladder image and the
   sharded pack of the same stream, and edge inputs of every ladder
   width: pfor and pforb, a lane grid no multiple of a block, one-row
   classes, words with bit 31 set, bases that wrap) for the three salts,
   X2, the EF decode, against its plain version on an edge arena (n = 0,
   w = 0, one-word regions, a list of many chunks, values past 2^31), and
   the specs of ``X2_REFUSED`` refused by its ``upload`` and
   ``decode_lists`` with no launch;
   both X1 entries timed in turns with their plain versions at the main
   path's shapes;
4. decode path: ``decode_stream(..., runs=2000, check_collection,
   device="cuda")`` for both types through the gather image and through
   the ladder image, exact over every list; launch counts reset just
   before and read just after each: one fused launch a run and no
   stand-alone K1-K3 launch (gather), one X1 launch a run (ladder);
5. bench path: ``tools.bench.run`` on the card at full size: the gather
   and ladder legs of both types under 2000 chained runs (the ladder
   legs checked against the whole collection, the gather legs against a
   sample of lists, as ``bench.py`` does) and the store probe (K5);
   launch counts reset just before and read just after; the record is
   printed with the card in it (one X1 launch a ladder run); torch.profiler
   traces of 50 chained ladder runs through X1 and through the torch-op
   chain (device busy time against the bytes bound), and both DINT ladder
   images chained in turns, X1 beside the torch-op chain;
6. K5 against its plain version under ``torch.equal`` at the bench
   output size, at one tile, at tile heights that are no power of two
   and, through its C entry, with a last tile cut short, the same three
   salts; its time in turns with ``fill_`` on the same bytes and the
   bound; the probe's
   chain salt on the card against the plain version's on the host;
7. ablation path: the per-unit plan of the single_rect stream,
   ``tools.kernel_ablate.run`` over it (every variant checked against
   ``gather_flat`` on the whole plan, then timed under the salted
   chain); launch counts reset just before and read just after; then K6
   and K7 against ``decode_gather_rows`` (their plain version) on 512
   plan rows and an edge batch (indices outside [0, 256), n = 0, table
   words with the sign bit, rows that repeat one index 256 times), and
   against ``gather_flat`` on the whole plan, the same three salts,
   under ``torch.equal``; their times, the plain version's, and K1's on
   the same rows;
8. serve data: from the phase-2 collection, the ``.sizes`` file, a
   ``multi_packed_dint`` index (``tools.create_freq_index``), its wand
   data (``tools.create_wand_data``) and a 500-query log (2-5 distinct
   uniform terms a query, seed 7) plus four edge queries; each step
   timed;
9. serve path: the index loaded, ``TermDecoder(device="cuda")`` and a
   ``DeviceServingStore`` over every term (K1-K3 decode the index once),
   then the log through ``tools.queries``' device path: ``ranked_or``
   with k 10 (fused store, K4), then ``wand`` and ``maxscore`` (the same
   store after the Block-Max survival pass on the card dropped the
   blocks that cannot reach a top-10), one warm-up and 10 timed passes
   each, and ``and``/``or`` counts; launch counts reset just before and
   read just after, K4's also per op (once a bucket a pass); K1-K3
   against their twins, and the fused launch against its plain version
   in both flags, under ``torch.equal`` on the class tensors of the
   docid and freq engines that path built;
10. K4 against its plain version under ``torch.equal`` at every bucket
    shape of the log, pruned and unpruned, and on an edge batch, each
    unpruned shape timed;
11. exactness: every term's docids and freqs decoded on the card equal
    the collection; every query's top-10 scores (and the scores of
    the returned docids), unpruned and pruned, equal a numpy oracle
    over the collection files within rtol 2e-4, atol 1e-5, with as many
    results; pruning removed some block; the and/or counts equal
    numpy's;
12. the survival pass on the card, on the log's events, against a
    float64 numpy replay of the pointwise bound (fatal if the card
    prunes a block the replay keeps) and against the same function on
    the CPU (differing mask bytes counted), with the metadata pass's
    parts timed;
13. the host engine on the log's first 32 queries, one pass: ``wand``
    and ``maxscore`` equal the device engine's top-10, ``ranked_and``
    the oracle's sums over the device engine's AND members, the lazy
    ``and``/``or`` the device counts; each op once through
    ``tools.queries.run_op``;
14. torch.profiler traces of 3 serving passes, unpruned and pruned;
15. raw engine: ``decode_stream(..., engine="raw", runs=100,
    check_collection, device="cuda")`` for both types, exact over every
    list, launches counted from zero: X3 once a pass (102), one launch
    over every tile, ``decode_units_plain`` never on the card, no other
    kernel; the bucket census (units clean and dirty, tiles per (W, N,
    b)) and the pass's blocks (rows a block, warp rows); X3's pass
    against its plain version under ``torch.equal`` (val, produced,
    consumed) on every tile of both streams, and on edge tiles (b 16 and
    8, dirty and clean, W no multiple of 32, w_valid 0 and 1, exceptions
    across X3's run, warp and chunk edges, runs, table offsets that wrap)
    one a launch and all in one mixed pass; X3 timed a census class
    (the class's tiles alone in a pass table) and a whole pass, one
    launch, median of 50, L2 flushed, against the bytes bound and its
    plain version (each tile's median, summed); the bad passes of
    ``X3_REFUSED`` (slots past the buffer, two tiles on one row, a row
    in no tile, overlapping slots, tokens past the buffer) refused by
    ``PassTable`` with no launch; the engine's build timed once a
    stream; torch.profiler traces of 20 passes through X3 and 2 through
    its plain version (wall against busy);
16. zoo: the eleven ``VROOM_ZOO`` types encoded from the phase-2
    collection (``tools.encode.encode_zoo_many``: every type's lists in
    one pool of a process per core, under ``.chip_smoke/zoo/``), each
    decoded by ``tools.decode``'s device path through the ladder image
    at 500 chained runs and, for
    the eight types with one, through its wire-structure engine at 100,
    every list checked, launches counted from zero for each (one X1
    launch a run on the ladder image and on optpfor's folded classes,
    one X4 launch a run on the five byte codecs' wire engines);
    ints/s, image bytes an int and cold start per type; each ladder image
    chained in turns through X1 and the torch-op chain; for the five byte
    codecs, X4 against its plain version under ``torch.equal`` on every
    class for the three salts (and on edge classes of both group widths),
    the chain's checksum on the card equal to the host's, X4 timed in
    turns with its plain version against the bytes bound and the chain
    in turns through X4 and the torch-op chain; torch.profiler traces of
    the ladder chain, of each wire engine family and of the byte
    engine's torch-op chain;
17. sharded steps, one NCCL rank on the card (``parallel.dist.run_ranks``;
    NCCL runs one rank a card and the host has one): ``stats_training_step``
    over every full 256-int block of the collection's docid gaps with
    65,536 buckets, equal to a numpy replay of the same hashes, its mass
    the blocks times the sum of 256/s; ``ladder_shard_pack`` and
    ``ladder_sharded_decode_step`` over the single_rect stream's values,
    reassembled equal to the source and to
    ``UnpackEngine.decode_all_ordered``, its classes in one launch of X1's
    rows entry (counted in the rank); the dry run's AND and top-k steps
    at its shapes against numpy; each step timed by CUDA events; then,
    in this process, X1's rows entry on views of the same stream's pack
    for 3 ranks uploaded as one tensor a width (each rank's offset
    slice, that slice from its second row, every other row of it)
    against ``ladder_rows_plain`` under ``torch.equal``;
18. sharded serving: ``serve_ranked_sharded`` on one NCCL rank over the
    phase-8 index and log, unpruned and pruned, top-10 equal to phase
    11's oracle (rtol 2e-4, atol 1e-5, as many results); launch counts
    reset in the rank just before and read just after: the fused class
    launch ran and no stand-alone K1-K3 launch did; µs a query beside
    the fused store's ``ranked_or``;
19. the statistics merge: ``collectors.collect_multi`` and
    ``collect_single`` over the collection's docid gaps with
    ``WindowCounter(device="cuda")`` and with numpy merges, equal as sets
    of (window, count) for every key; the merges the card took (at least
    one), the rows they merged and both wall times;
20. the multi-rank dry run: ``parallel.dryrun.dryrun_multichip(4,
    device="cpu")`` on four gloo ranks of the host's CPU, its summary
    line (the multi-rank logic; one card proves one rank only);
21. index families: ``block_optpfor``, ``ef`` and ``opt`` built from the
    phase-2 collection at full size by ``tools.create_freq_index
    --check``, each build's seconds and bits an int;
22. block serving: ``tools.queries block_optpfor
    ranked_or:wand:maxscore:and:or --engine device`` over the phase-8
    log, launches counted from zero: K4 once per bucket per pass, the
    three ranked ops through the fused store, wand and maxscore pruned
    through ``ZooBlockCache``; K4 against its plain version at that
    store's bucket shapes (pruned and unpruned), every top-10 against
    phase 11's oracle (unpruned and pruned), the survival masks against
    the float64 replay, the and/or counts against phase 11's, the log's
    lists against the collection; µs a query beside phase 9's
    ``ranked_or``;
23. EF: every list of the ``ef`` index through ``EFTermDecoder(device=
    "cuda", device_ef=True)``, one X2 call, equal to the host decode and
    the collection; ``decode_lists``' parts (prepare, upload, decode,
    download, split) timed one by one, the pinned download in turns with
    a pageable one; ``decode_lists`` end to end in a fresh process, its
    first call apart from its warm ones; X2 against its plain version on
    every list under ``torch.equal``, both timed in turns (CUDA events, L2
    flushed; X2 also warm, with no flush, in the same turns) against the
    bytes bound and the host's ``list_docids`` loop, with profiler
    traces; then ``tools.queries ef ... --engine device
    --device-ef``: X2 launched, no K4 and no class launch (the row path,
    unpruned, the reference's gates), top-10 against the oracle, counts
    against phase 11's;
24. the native cursor engine: ``tools.queries <kind>
    and:or:ranked_or:wand:maxscore --engine native`` over
    ``multi_packed_dint``, ``block_optpfor`` and ``ef`` (its u32 block
    view), totals equal to phase 11's counts and the oracle's; per query,
    counts and top-10 scores;
25. ``LocalDecodeEngine`` over the packed per-unit plan of both DINT
    streams: 200 chained runs (CUDA events) and a ``decode_all``,
    launches counted from zero (one fused launch a run), every list
    equal to the collection, the chain's salt after 2 runs equal to the
    plain version's on the host; ints/s beside phase 4's;
26. ``tools.check_encoded_data`` through its ``main`` on both DINT
    streams on the card (one run each, every list checked; launches
    counted from zero: the fused class launch and no class kernel
    alone), on the ``vbyte`` zoo stream of phase 16 (host decode), and
    on the single_rect stream against a copy of the collection with one
    posting changed, which must end in SystemExit;
27. ``tools.check_index`` on the phase-8 index and the three phase-21
    indexes, each timed, and on the phase-8 index against the changed
    collection, which must end in SystemExit;
28. ``tools.pair_wise_intersect`` over the phase-8 log's two-term
    queries: ``--engine native`` on the phase-8 index, ``--engine
    python`` on the card over it (launches counted from zero: the fused
    class launch decodes the docids) and over ``block_optpfor`` and
    ``ef`` (host decode, no launch); pairs and total results equal to a
    numpy oracle over the collection's lists;
29. ``tools.dict_perf_test`` on both bench dictionaries, ``native`` at
    10M copies and 10 runs and ``numpy`` (its checksum equal to a numpy
    replay of the same draw); the numpy coders of
    ``codecs/encode_batch`` (``prefer_native=False``) on the
    collection's first lists up to 1M ints (single) and 50K (multi),
    bytes equal to the native encoder's, both timed.  The fused
    launches of phases 26 and 28 count under the path ``tools``;
30. ``tools.scale_test`` through its ``main`` at ``--ints 4e6`` (3.65M
    postings) under ``.chip_smoke/scale``: the build stages,
    ``--decode`` (both legs checked against the whole collection) and
    ``--serve`` (device top-10 against the host ``ranked_or``); launch
    counts reset just before and read just after: the fused class
    launch, X1 and K4 each launched;
31. ``dint_tpu_torch.entry.entry()``'s ``fn`` on the card (one fused
    class launch, counted from zero) against its plain version under
    ``torch.equal`` and, on every valid lane, against ``entry("cpu")``
    (the reference's portable branch);
32. the fused launch on the benchmark cell's image
    (``benchmark/configs/gov2s-rect.json``: 90,855,447 postings from
    ``--seed``, encoded and planned as the cell's set-up does it, under
    ``.chip_smoke/cell``, removed after): the engine's trimmed classes
    against the same classes as padded triples, equal in both flags for
    the three salts, then in turns cold and chained (128 runs with the
    benchmark's checksum), each beside the bound of its own bytes.

Phases 3 and 7 also time ``torch.gather`` (the library call computing
K1's and K6/K7's gather, without the salt and the n mask) in turns with
the kernels on the same rows.

Prints the stats records (``{"serve_pruned": ...}``, ``{"raw": ...}``,
``{"zoo": ...}``, ``{"sharded_steps": ...}``, ``{"sharded_serve": ...}``,
``{"stats_merge": ...}``, ``{"dryrun": ...}``, ``{"family_builds":
...}``, ``{"block_serve": ...}``, ``{"ef": ...}``, ``{"native": ...}``,
``{"local_chain": ...}``, ``{"check_encoded_data": ...}``,
``{"check_index": ...}``, ``{"pair_wise_intersect": ...}``,
``{"dict_perf_test": ...}``, ``{"scale_test": ...}``, ``{"entry":
...}`` and ``{"cell_image": ...}`` lines among them), the
dry run's summary line, the card line, one ``{"kernels": [...]}`` line
(K1-K7, the fused class launch, X1's two entries, X2, X3 and X4)
and, last,
``{"ok": true,
"device": {...}}``.  Exits non-zero with no result line when there is
no card or no checkout around it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
# The raw engine launches X3 once a pass (over the 16 and 90 tiles of the
# two bench streams) and fetches one value a pass, as the reference does;
# its torch-op version (X3's plain version) took tenths of a second a
# pass, so it is profiled over a couple of passes only.
RAW_RUNS = 100
RAW_PROFILE_RUNS = 20
RAW_PLAIN_PROFILE_RUNS = 2
X3_ITERS = 50  # CUDA-event timings of an X3 pass
X3_PLAIN_ITERS = 5  # of its plain version a tile (a multi_packed pass ~0.4 s)
X4_ITERS = 50  # CUDA-event timings of X4 and its plain version
X4_CHECK_RUNS = 3  # chained runs whose checksum the card and host share
BYTE_WIRE = ("vbyte", "maskedvbyte", "streamvbyte", "varintgb",
             "varintg8iu")  # the zoo types whose wire engine runs X4
ZOO_RUNS = 500  # chained runs of a zoo type's ladder image
ZOO_WIRE_RUNS = 100  # chained runs of a wire-structure engine
ZOO_PROFILE_RUNS = 50
# the chains profiled: the ladder image (one type stands for all eleven:
# the engine is the same) and each wire engine family
ZOO_PROFILED = (("vbyte", False), ("optpfor", True), ("qmx", True),
                ("simple16", True), ("vbyte", True))
MASK = 0xFFFFFFFF
SERVE_TYPE = "multi_packed_dint"  # the index of bench_artifacts/queries.json
SERVE_RUNS = 10  # timed serving passes after one warm-up
BOOL_RUNS = 3
RANKED_OPS = ("ranked_or", "wand", "maxscore")  # through the fused store
RANKED_AGAIN = "ranked_or_again"  # ranked_or timed once more after them
HOST_QUERIES = 32  # the log's first queries, through the host engine
HOST_OPS = ("wand", "maxscore", "ranked_and", "and", "or")
QUERIES = 500
QUERY_SEED = 7  # scripts/ab_queries.py's query log
TOPK = 10
RTOL, ATOL = 2e-4, 1e-5  # tests/test_device_serve.py:87
PROFILE_PASSES = 3
K4_EDGE_G = (1, 7, 8193)
STATS_BUCKETS = 1 << 16  # stats_training_step's n_buckets on the card
STEP_ITERS = 20  # CUDA-event timings of a sharded step
SHARDED_SERVE_RUNS = 3  # timed serve_ranked_sharded calls after a cold one
STATS_COLLECTORS = ("multi", "single")
DRYRUN_RANKS = 4
FAMILY_KINDS = ("block_optpfor", "ef", "opt")  # built at full size, --check
BLOCK_SERVE = "block_optpfor"  # the block kind served through K4
FAMILY_OPS = "ranked_or:wand:maxscore:and:or"  # tools.queries --engine device
NATIVE_OPS = "and:or:ranked_or:wand:maxscore"  # tools.queries --engine native
NATIVE_KINDS = (SERVE_TYPE, BLOCK_SERVE, "ef")
FAMILY_RUNS = 3  # timed passes of tools.queries over the new kinds
EF_DEVICE_ITERS = 50  # CUDA-event timings of X2 and its plain version
EF_SPLIT_ROUNDS = 3  # decode_lists' download and split, in turns
EF_E2E_ROUNDS = 7  # warm decode_lists calls in the fresh process
LOCAL_CHAIN_RUNS = 200  # chained runs of LocalDecodeEngine.decode_chain
LOCAL_PLAIN_RUNS = 2  # its chain salt held to the plain version's
TOOLS_ZOO = "vbyte"  # the zoo stream check_encoded_data reads (host decode)
PAIR_NATIVE_RUNS = 11  # src/pair_wise_intersect.cpp's 10 timed + 1
PAIR_PYTHON_RUNS = 3  # tools/pair_wise_intersect's default
PAIR_KINDS = ("block_optpfor", "ef")  # the python engine's other kinds
DICT_COPIES = 10_000_000  # src/dict_perf_test.cpp's copies and runs
DICT_RUNS = 10
CODER_SINGLE_INTS = 1_000_000  # ints the numpy coders parse, single
CODER_MULTI_INTS = 50_000  # and multi (six selectors, two widths each)
SCALE_INTS = 4e6  # tools.scale_test's --ints in phase 30 (3.65M postings)
ROWS_VIEW_RANKS = 3  # phase 17: the sharded pack uploaded whole for 3 ranks
DECODE_KERNELS = ("K1_gather32", "K2_gather16", "K3_zero")
FUSED = "K123_decode_classes"  # the engines' one launch over the classes
X1 = "X1_ladder_unpack"  # the ladder engines' one launch a run
X1_ROWS = "X1_ladder_rows"  # X1's entry for the sharded step's rows
X2 = "X2_ef_decode"
X3 = "X3_raw_decode"  # the raw engine's launch a pass
X4 = "X4_byteclass_unpack"  # the byte codecs' wire engine's launch a run
LADDER_TURN_RUNS = 500  # chained runs a turn, X1 beside the torch-op chain
ZOO_TURN_RUNS = 200
IN_FUSED = "_in_fused"  # counts key: fused launches that ran a class body
WALKED = "K123_walked"  # counts key: fused launches whose blocks walked
TRIMMED = "K123_trimmed"  # counts key: fused launches of trimmed classes
# the ablation's v_gather32 is K1 alone; its v_ship runs the fused launch
ABLATE_KERNELS = ("K1_gather32", "K6_onehot_block", "K7_onehot_group")
# Published H100 device-memory rates (NVIDIA data sheets), by card name.
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))
# Integer ALU rate outside the tensor cores: 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost (Hopper white paper), in operations a second.
SMS, SM_HZ = 132, 1.98e9
INT32_OPS_PER_S = SMS * 64 * SM_HZ
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (data sheet)
LIBRARY_GATHER = ("torch.gather(tab, 1, vidx): the same gather, int64 index "
                  "made beforehand, without the salt add and the n mask")
LIBRARY_GATHER16 = ("torch.gather(tab.view(int16), 1, vidx): the same u16 "
                    "gather into int16, int64 index made beforehand, without "
                    "the salt add and the n mask")
LIBRARY_FILL = "out.fill_(v) over the same output bytes"


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
    """Build every CUDA kernel library (one nvcc each) and the six
    native host libraries concurrently; return the slowest kernel
    build's wall seconds."""
    from dint_tpu_torch.codecs import native, zoonative
    from dint_tpu_torch.kernels import cuda_ext, planner_native
    from dint_tpu_torch.query import native_host
    from dint_tpu_torch.stats import native_stats
    from dint_tpu_torch.utils import bitnative

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
        "native zoo decoders": zoonative.get_lib,
        "native EF decoder": bitnative.get_lib,
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


def fused_args(engine):
    """(n0, cls16, cls32) of ``engine``'s classes as its runs pass them
    to decode_classes (the u16 and i32 classes trimmed); a class the
    engine has no rows of is None."""
    return engine.launch_args()


def fused_padded_args(engine):
    """The same classes as padded (vidx, tab, n) triples, made on the
    device from the trimmed form: what the fused launch read before it
    took classes trimmed."""
    n0 = engine.launch_args()[0]
    return (n0, engine.padded(16), engine.padded(32))


def zero_region(cls):
    """A padded (vidx, tab, n) triple with each row's first 16 table
    entries set to 0, as the planner leaves them, so that its trimmed
    form leaves them out (skip 16)."""
    from dint_tpu_torch.kernels import decode_local as dl

    v, t, n = cls
    t = t.clone()
    t[:, : dl.ZERO_ENTRIES * t.shape[1] // dl.TABLE_CLS] = 0
    return v, t, n


def fused_edge_cases(device):
    """[(label, (n0, cls16, cls32))] on the edge batch: the three classes
    of 67 rows each (no multiple of a block's 4 rows, so each class's
    last block is ragged and the next class starts a new block), the
    same with one class empty or absent, one class alone, and classes
    of 5, 3 and 1 rows; then each of them with the u16 and i32 classes
    trimmed (``trim_class``: random tables, so skip 0), and the 67-row
    classes with a zero region, trimmed (skip 16) and padded."""
    from dint_tpu_torch.kernels import decode_local as dl

    v, t16, t32, n = edge_batch(device)
    c16, c32 = (v, t16, n), (v, t32, n)

    def head(cls, k):
        return tuple(t[:k] for t in cls)

    cases = [
        ("edge 67/67/67", (n, c16, c32)),
        ("edge no zero class", (None, c16, c32)),
        ("edge empty u16 class", (n, head(c16, 0), c32)),
        ("edge no i32 class", (n, c16, None)),
        ("edge i32 alone", (None, None, c32)),
        ("edge zero alone", (n, None, None)),
        ("edge 5/3/1 rows", (n[:5], head(c16, 3), head(c32, 1))),
    ]

    def trim(cls):
        return None if cls is None else dl.trim_class(*cls)

    cases += [(f"{label}, trimmed", (n0, trim(a), trim(b)))
              for label, (n0, a, b) in cases if a is not None or b is not None]
    z16, z32 = zero_region(c16), zero_region(c32)
    cases += [("edge 67/67/67 zero region", (n, z16, z32)),
              ("edge 67/67/67 zero region, trimmed",
               (n, dl.trim_class(*z16), dl.trim_class(*z32)))]
    return cases


def fused_refused_cases(device):
    """[(label, (n0, cls16, cls32))] that decode_classes refuses with a
    ValueError naming the class, on both devices and before any launch:
    a padded triple whose n is longer or shorter than its vidx and tab,
    and trimmed classes whose n, start table and data disagree in rows
    or bytes."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    v, t16, t32, n = edge_batch(device, rows=9)
    n[:] = (torch.tensor([0, 256, 17, 1, 255, 16, 100, 3, 40],
                         dtype=torch.int32) * dl.N_OUT // 256).to(device)
    one = torch.ones(1, dtype=torch.int32, device=device)
    z16 = dl.trim_class(*zero_region((v, t16, n)))
    z32 = dl.trim_class(v, t32, n)

    def bad(cls, **kw):
        return cls._replace(**kw)

    def starts_with(cls, row, col, delta):
        st = cls.starts.clone()
        st[row:, col] += delta
        return bad(cls, starts=st)

    def lane_past_table(cls):
        # a row's first valid lane reads an entry past the row's table
        st = cls.starts.cpu()
        r = int(torch.nonzero((cls.n.cpu() > 0)
                              & (st[1:, 1] - st[:-1, 1] < 30))[0])
        vv = cls.vidx.clone()
        vv[16 * int(st[r, 0])] = 255
        return bad(cls, vidx=vv)

    return [
        ("a padded u16 n longer than its vidx", (None, (v, t16, torch.cat(
            [n, one])), None)),
        ("a padded i32 n shorter than its vidx", (None, None,
                                                  (v, t32, n[:-1]))),
        ("a trimmed u16 n of fewer rows than its start table",
         (None, bad(z16, n=z16.n[:-1]), None)),
        ("a trimmed i32 n of more rows than its start table",
         (None, None, bad(z32, n=torch.cat([z32.n, one])))),
        ("a trimmed u16 vidx short of its start table",
         (None, bad(z16, vidx=z16.vidx[:-16]), None)),
        ("a trimmed i32 table short of its start table",
         (None, None, bad(z32, tab=z32.tab[:-4]))),
        ("a trimmed u16 vidx of a partial 16-byte word",
         (None, bad(z16, vidx=z16.vidx[:-1]), None)),
        ("a trimmed u16 row whose vidx range is short of its n",
         (None, bad(z16, n=z16.n + (z16.n > 0).to(torch.int32) * 16),
          None)),
        ("a trimmed i32 start table that falls",
         (None, None, starts_with(z32, 3, 0, -2))),
        ("a trimmed u16 start table below 0",
         (None, starts_with(z16, 0, 1, -1), None)),
        ("a trimmed u16 row of more vidx lanes than n_out",
         (None, bad(starts_with(z16, 2, 0, dl.N_OUT // 16), vidx=torch.cat(
             [z16.vidx, z16.vidx.new_zeros(dl.N_OUT)])), None)),
        ("a trimmed i32 row's table past the row's table",
         (None, None, bad(starts_with(z32, 1, 1, 80), tab=torch.cat(
             [z32.tab, z32.tab.new_zeros(320)])))),
        ("a trimmed u16 lane that reads past its row's table",
         (None, lane_past_table(z16), None)),
        ("a trimmed i32 class of skip 8", (None, None, bad(z32, skip=8))),
    ]


def check_fused(cases) -> int:
    """The fused class launch equal to its plain version on the card, in
    both flags and for every salt, on every (label, (n0, cls16, cls32))
    of ``cases``; return max |kernel - plain| over the u32 values."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    worst = 0
    for label, args in cases:
        for s in SALTS:
            st = torch.tensor([s], dtype=torch.int64, device="cuda")
            for exact in (False, True):
                got = dl.decode_classes(*args, st, exact)
                want = dl.decode_classes_plain(*args, st, exact)
                torch.cuda.synchronize()
                diff = u32_err(got, want) if got.numel() else 0
                worst = max(worst, diff)
                if not torch.equal(got, want):
                    fail(f"the fused launch disagrees with its plain "
                         f"version on {label}, salt {s:#x}, exact={exact} "
                         f"(max abs err {diff})")
    return worst


def check_fused_refusals(device) -> int:
    """Every case of ``fused_refused_cases`` refused by decode_classes
    with a ValueError naming its class, and no launch; returns the
    count."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    salt = torch.tensor([5], dtype=torch.int64, device=device)
    cases = fused_refused_cases(device)
    for label, args in cases:
        which = "u16" if args[1] is not None else "i32"
        before = dl.decode_classes.launches
        try:
            dl.decode_classes(*args, salt)
        except ValueError as e:
            if f"{which} class" not in str(e):
                fail(f"decode_classes refused {label} without naming its "
                     f"class: {e}")
        else:
            fail(f"decode_classes took {label}")
        if dl.decode_classes.launches != before:
            fail(f"decode_classes launched on {label}")
    return len(cases)


K3_ROWS = (1, 5, 67, 1000, 4097)  # no multiple of a K3 block at any n_out
GUARD = -123456789  # the row after K3's output, which it must not touch


def check_k3_widths(device="cuda") -> int:
    """K3 alone at every n_out the kernels take, for row counts that are
    no multiple of a block and the three salts: equal to its twin under
    torch.equal, the guard row after its output untouched; return max
    |kernel - twin|."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    rng = np.random.default_rng(13)
    worst = 0
    for n_out in dl._N_OUT_OK:
        for rows in K3_ROWS:
            n_np = rng.integers(0, n_out + 1, rows).astype(np.int32)
            n_np[: min(rows, 2)] = (n_out, 0)[: min(rows, 2)]
            n = torch.from_numpy(n_np).to(device)
            for s in SALTS:
                st = torch.tensor([s], dtype=torch.int64, device=device)
                buf = torch.full((rows + 1, n_out), GUARD, dtype=torch.int32,
                                 device=device)
                got = dl.zero(n, st, n_out, out=buf[:rows])
                want = dl.zero_plain(n, st, n_out)
                torch.cuda.synchronize()
                worst = max(worst, u32_err(got, want))
                if not torch.equal(got, want):
                    fail(f"K3 disagrees with its twin at n_out {n_out}, "
                         f"{rows} rows, salt {s:#x}")
                if not bool((buf[rows] == GUARD).all()):
                    fail(f"K3 wrote past its output at n_out {n_out}, "
                         f"{rows} rows, salt {s:#x}")
    return worst


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
        args = list(engine.padded(mode)) if mode else [c.n]
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
    kernel body.  Every row counts, the padding rows (n = 0) of a class
    too: the gather body reads their vidx and tables with the rest (one
    trip to device memory a block, nothing waits for n)."""
    out, n_b, salt_b = rows * n_out * 4, rows * 4, 8
    if name == "K1_gather32":
        return rows * n_out + rows * 1024 + n_b + salt_b + out, 4 * rows * n_out
    if name == "K2_gather16":
        return rows * n_out + rows * 512 + n_b + salt_b + out, 5 * rows * n_out
    return n_b + salt_b + out, 2 * rows * n_out


def time_ms(fn, iters: int, flush) -> float:
    """Median milliseconds of ``fn()`` over ``iters`` launches, each
    timed by CUDA events after the L2 cache was flushed by reading
    ``flush`` (a read leaves no dirty lines to write back; None: no
    flush, the call warm behind the one before it).  The card
    first sleeps ~25 ms so that the host has queued every launch before
    the card reaches it: the events then time the card's work, not the
    host's launch latency."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(iters):
        if flush is not None:
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


def time_in_turns(fns: dict, iters: int, flush, rounds: int = 2,
                  warm=()) -> dict:
    """{name: milliseconds} of each ``fns[name]()``: ``rounds`` passes
    over the functions in their order, each timed by ``time_ms`` (the
    names in ``warm`` with no flush); the mean of a function's round
    medians."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(time_ms(fn, iters,
                                     None if name in warm else flush))
    return {name: sum(v) / len(v) for name, v in got.items()}


HEADS = ((37, 301, 19), (3, 40, 2))  # serving-sized launches: rows a class
CHAIN_RUNS = 128  # chained runs a timed call of fused_forms, as the benchmark's


def fused_bytes(engine, padded=None) -> int:
    """Bytes one fused launch over ``engine``'s classes moves: its class
    tensors read once (the trimmed ones the engine keeps, or the
    ``padded`` triples), the output written once, the salt."""
    from dint_tpu_torch.kernels import decode_local as dl

    out = engine.rows * dl.N_OUT * 4 + 8
    if padded is None:
        return out + engine.card_bytes()
    n0 = padded[0]
    return out + (0 if n0 is None else n0.numel() * 4) + sum(
        t.numel() * t.element_size() for c in padded[1:] if c is not None
        for t in c)


def heads_of(args, rows, padded: bool):
    """The first ``rows`` = (R0, R16, R32) rows of each class of fused
    launch args (trimmed classes through ``TrimmedClass.head``)."""
    n0, c16, c32 = args
    r0, r16, r32 = rows

    def head(c, k):
        if c is None:
            return None
        return tuple(t[:k] for t in c) if padded else c.head(k)

    return (None if n0 is None else n0[:r0], head(c16, r16), head(c32, r32))


def chained_us(engine, args, runs: int = CHAIN_RUNS, calls: int = 5,
               check: bool = False) -> float:
    """Median µs a run of ``calls`` timed calls of ``runs`` chained runs
    as the benchmark's window makes them: a fused launch over ``args``,
    then the checksum of the first 128 rows of each class, the next salt
    from it, on the card."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    rows = torch.cat([torch.arange(c.base, c.base + min(c.rows, 128))
                      for c in engine._classes if c.rows]).to(engine.device)
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device=engine.device)

    def call(s):
        for _ in range(runs):
            buf = dl.decode_classes(*args, s, check=check)
            acc = buf.index_select(0, rows).sum(dtype=torch.int32)
            del buf
            s = (torch.add(s, acc, alpha=4) + 1) & MASK
        return s

    salt = call(salt)
    torch.cuda.synchronize()
    per = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        salt = call(salt)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) * 1e3 / runs)
    return sorted(per)[len(per) // 2]


def fused_forms(engine, flush, rounds: int = 3) -> dict:
    """The fused launch over ``engine``'s trimmed classes and over the
    same classes as padded triples (the reads of the launch before it
    took trimmed classes), in turns: chained as the benchmark runs it
    (µs a run), and on the serving-sized heads of ``HEADS`` (one small
    tile a block), cold; each head's two forms equal first."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    forms = {"trimmed": fused_args(engine),
             "padded": fused_padded_args(engine)}
    got = {"chained_us": {k: [] for k in forms}, "heads_us": {}}
    for _ in range(rounds):
        for k, a in forms.items():
            got["chained_us"][k].append(chained_us(engine, a))
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device=engine.device)
    for rows in HEADS:
        h = {k: heads_of(a, rows, k == "padded") for k, a in forms.items()}
        if not torch.equal(dl.decode_classes(*h["trimmed"], salt),
                           dl.decode_classes(*h["padded"], salt)):
            fail(f"the {rows} head decodes differently trimmed and padded")
        t = time_in_turns({k: (lambda a=a: dl.decode_classes(
            *a, salt, check=False)) for k, a in h.items()}, 50, flush,
            rounds=rounds)
        got["heads_us"]["/".join(map(str, rows))] = {
            k: v * 1e3 for k, v in t.items()}
    got["chained_us"] = {k: sorted(v)[len(v) // 2]
                         for k, v in got["chained_us"].items()}
    return got


def time_kernels(engine, errs, card_name):
    """One kernels-line entry per class kernel and one for the fused
    launch, at the bench image's shapes, timed in turns in one go: K1
    alone, an empty grid of K1's shape, the fused launch (the engine's
    trimmed classes, and the same classes as padded triples), the three
    stand-alone launches back to back, K2 and K3 alone, the zero class
    alone in the fused launch; then the fused launch's two forms chained
    and on serving-sized heads (``fused_forms``)."""
    import torch

    from dint_tpu_torch.kernels import cuda_ext
    from dint_tpu_torch.kernels import decode_local as dl

    N_OUT = dl.N_OUT
    rate = hbm_rate(card_name)
    flush = torch.zeros(24 << 20, dtype=torch.int32, device=engine.device)
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device=engine.device)
    srcs = {
        "K1_gather32": ("_gather32_body", 944),
        "K2_gather16": ("_gather16_body", 914),
        "K3_zero": ("_zero_body", 983),
    }
    cases = {name: calls[0]  # the bench image's class
             for name, calls in kernel_cases(engine).items()}
    lib = cuda_ext.lib("libdintgather.so")
    k1_blocks = cases["K1_gather32"][2] * N_OUT // 1024
    stream = torch.cuda.current_stream(engine.device).cuda_stream

    def empty():
        cuda_ext.check("libdintgather.so", "dint_empty_launch",
                       lib.dint_empty_launch(k1_blocks, stream))

    args = fused_args(engine)
    padded = fused_padded_args(engine)
    buf = torch.empty((engine.rows, N_OUT), dtype=torch.int32,
                      device=engine.device)

    # the library call beside K1: torch.gather computes its gather
    # out[r, j] = tab[r, vidx[r, j]] on the same class tensors (its index
    # must be int64, made here, outside the timing), without K1's salt
    # add and n mask
    k1_vidx, k1_tab, _ = padded[2]
    lib_idx = k1_vidx.to(torch.int64)
    # K2's: torch.gather on the int16 view of the u16-packed table (byte
    # index idx is halfword idx of the little-endian words), no salt, no
    # n mask; K3's: fill_ over the same output bytes
    k2_vidx, k2_tab, _ = padded[1]
    lib16_tab, lib16_idx = k2_tab.view(torch.int16), k2_vidx.to(torch.int64)
    lib_fill = torch.empty((cases["K3_zero"][2], N_OUT), dtype=torch.int32,
                           device=engine.device)

    def three():
        for c in engine._classes:
            o = buf[c.base : c.base + c.rows]
            if c.mode == 0:
                dl.zero(c.n, salt, N_OUT, out=o)
            elif c.mode == 16:
                dl.gather16(*padded[1], salt, out=o)
            else:
                dl.gather32(*padded[2], salt, out=o)

    # the zero class alone in the fused launch (no u16 or i32 rows)
    zero_args = (args[0], None, None)
    zero_buf = buf[: cases["K3_zero"][2]]
    fns = {"K1_gather32": lambda: cases["K1_gather32"][0](salt),
           "empty": empty,
           FUSED: lambda: dl.decode_classes(*args, salt, out=buf,
                                            check=False),
           "fused_padded": lambda: dl.decode_classes(*padded, salt, out=buf),
           "three": three,
           "K2_gather16": lambda: cases["K2_gather16"][0](salt),
           "K3_zero": lambda: cases["K3_zero"][0](salt),
           "library_gather": lambda: torch.gather(k1_tab, 1, lib_idx),
           "library_gather16": lambda: torch.gather(lib16_tab, 1, lib16_idx),
           "library_fill": lambda: lib_fill.fill_(0x5A5A5A5A),
           "zero_in_fused": lambda: dl.decode_classes(*zero_args, salt,
                                                      out=zero_buf)}
    ms = time_in_turns(fns, 50, flush)
    plains = {name: (lambda p=cases[name][1]: p(salt))
              for name in DECODE_KERNELS}
    plains[FUSED] = lambda: dl.decode_classes_plain(*args, salt)
    plain_ms = {name: time_ms(fn, 5, flush) for name, fn in plains.items()}
    out = []
    for name in DECODE_KERNELS:
        rows = cases[name][2]
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
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "rows": rows,
            "bytes": nbytes,
        })
    out[0]["empty_launch_ms"] = ms["empty"]
    out[0]["empty_launch_blocks"] = k1_blocks
    out[0]["library_ms"] = ms["library_gather"]
    out[0]["library_call"] = LIBRARY_GATHER
    out[1]["library_ms"] = ms["library_gather16"]
    out[1]["library_call"] = LIBRARY_GATHER16
    out[2]["library_ms"] = ms["library_fill"]
    out[2]["library_call"] = LIBRARY_FILL
    out.append({
        "name": FUSED,
        "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/decode_gather.cu",
        "replaces": "dint_tpu/kernels/decode_local.py:1086 (the class calls "
                    "of one run, _run :1105 in _pallas_split_fns :1067)",
        "launches": 0,
        "max_abs_err": errs[FUSED],
        "ms": ms[FUSED],
        "plain_ms": plain_ms[FUSED],
        # the bound from the trimmed image's bytes: every class tensor
        # the engine keeps read once, the output written once, the salt
        **bound_entry(fused_bytes(engine), sum(
            kernel_bytes_ops(n, cases[n][2], N_OUT)[1]
            for n in DECODE_KERNELS) / INT32_OPS_PER_S * 1e3, card_name),
        "library_ms": None,
        "rows": engine.rows,
        # the same classes as padded triples, in the same turns, and the
        # bytes they read
        "padded_ms": ms["fused_padded"],
        "padded_bytes": fused_bytes(engine, padded),
        **fused_forms(engine, flush),
        "three_launches_ms": ms["three"],
        # the zero class alone in the fused launch, and its bytes bound
        "zero_class_ms": ms["zero_in_fused"],
        "zero_class_bound_ms": out[2]["bound_ms"],
    })
    for k in out:
        log(f"{k['name']} {k['ms'] * 1e3:.2f} us (bound "
            f"{k['bound_ms'] * 1e3:.2f} us, plain {k['plain_ms'] * 1e3:.1f} us)")
    f = out[-1]
    log(f"fused launch trimmed {f['ms'] * 1e3:.2f} us, padded "
        f"{f['padded_ms'] * 1e3:.2f} us; chained "
        f"{f['chained_us']['trimmed']:.2f} / {f['chained_us']['padded']:.2f}"
        f" us a run; heads (trimmed / padded, us): " + ", ".join(
            f"{h} {v['trimmed']:.2f} / {v['padded']:.2f}"
            for h, v in f["heads_us"].items()))
    log(f"empty grid of {k1_blocks} blocks {ms['empty'] * 1e3:.2f} us; the "
        f"three class launches back to back {ms['three'] * 1e3:.2f} us; the "
        f"zero class alone in the fused launch "
        f"{ms['zero_in_fused'] * 1e3:.2f} us")
    del flush
    return out


# ---------------------------------------------------------------------------
# X1 (the fused ladder unpack) and X2 (the EF decode)
# ---------------------------------------------------------------------------


def x1_edge_classes(device, seed: int = 0):
    """LadderClasses of every ladder width, a pfor class of 300 blocks
    (M = 3, so a class's words are no multiple of a block's 1024) and a
    pforb class of 5 (M = 1) each, interleaved as an engine's: fields at
    their maximum, bit 31 in every word's top field, bases near 2^32 so
    that base + field + salt wraps."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    rng = np.random.default_rng(seed)
    classes = []
    for w in ud._LADDER:
        for rows, base in ((300, False), (5, True)):
            v = rng.integers(0, 1 << w, (rows, 256), dtype=np.uint64)
            v[:, ::7] = (1 << w) - 1
            v[:, 32 // w - 1 :: 32 // w] |= 1 << (w - 1)
            wT = ud._u32_tensor(ud._lane_major(ud._pack_w(
                v.astype(np.uint32), w)), device)
            bT = None
            if base:
                b = rng.integers(0, 1 << 32, rows, dtype=np.uint64)
                b[:3] = (MASK, 1 << 31, 0)
                bT = ud._u32_tensor(ud._lane_major(
                    b.astype(np.uint32)[:, None])[0], device)
            classes.append((w, wT, bT))
    return ud.LadderClasses(classes, torch.device(device))


def rows_view_cases(flat: np.ndarray, device):
    """Phase 17's views: ``steps.ladder_shard_pack`` of ``flat`` for
    ROWS_VIEW_RANKS ranks, each width's (S, NBw, words_w) uploaded as one
    tensor, and per rank its slice (an offset view), that slice from its
    second row (offsets that are no multiple of 16 B) and every other
    row of it (not contiguous): [(label, {w: view})]."""
    from dint_tpu_torch.kernels import unpack_device as ud
    from dint_tpu_torch.parallel import steps

    packed, _, _, _ = steps.ladder_shard_pack(flat, ROWS_VIEW_RANKS)
    whole = {w: ud._u32_tensor(a, device) for w, a in packed.items()}
    cases = []
    for s in range(ROWS_VIEW_RANKS):
        cases += [(f"rank {s}", {w: a[s] for w, a in whole.items()}),
                  (f"rank {s} from row 1",
                   {w: a[s][1:] for w, a in whole.items()}),
                  (f"rank {s} every other row",
                   {w: a[s][::2] for w, a in whole.items()})]
    return cases


def check_rows_views(cases) -> dict:
    """X1's rows entry on every view of ``cases`` equal to
    ``ladder_rows_plain`` under torch.equal; returns the worst error,
    the views that sat at no 16-byte boundary and those not contiguous
    (fatal if there was none of either)."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    worst, unaligned, strided = 0, 0, 0
    for label, views in cases:
        got = ud.ladder_rows(views)
        torch.cuda.synchronize()
        for w, a in views.items():
            unaligned += a.data_ptr() % 16 != 0
            strided += not a.is_contiguous()
            want = ud.ladder_rows_plain(a, w)
            diff = u32_err(got[w], want) if want.numel() else 0
            worst = max(worst, diff)
            if not torch.equal(got[w], want):
                fail(f"X1's rows entry disagrees with its plain version on "
                     f"{label}, w={w} (max abs err {diff})")
    if not (unaligned and strided):
        fail(f"the rows views held {unaligned} unaligned and {strided} "
             "strided tensors: the offset check tested nothing")
    return {"views": sum(len(v) for _, v in cases), "max_abs_err": worst,
            "unaligned": int(unaligned), "strided": int(strided)}


def x1_edge_rows(device, seed: int = 1):
    """X1's rows entry input: every ladder width, 1 to 10 rows (one width
    with a single row), words with bit 31 set."""
    from dint_tpu_torch.kernels import unpack_device as ud

    rng = np.random.default_rng(seed)
    out = {}
    for i, w in enumerate(ud._LADDER):
        rows = 1 if i == 3 else int(rng.integers(2, 11))
        words = rng.integers(0, 1 << 32, (rows, ud._row_words(w)),
                             dtype=np.uint64)
        words[:, ::3] |= 1 << 31
        out[w] = ud._u32_tensor(words, device)
    return out


def check_x1(lcs, packs) -> dict:
    """X1 equal to its plain version on the card under torch.equal: every
    LadderClasses of ``lcs`` for every salt, every rows input of
    ``packs``; return {entry: max |kernel - plain|} over the u32
    values."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    worst = {"X1_ladder_unpack": 0, "X1_ladder_rows": 0}
    for label, lc in lcs:
        for s in SALTS:
            st = torch.tensor([s], dtype=torch.int64, device="cuda")
            got = [o.clone() for o in ud.ladder_unpack(lc, st)]
            want = lc.plain(st)
            torch.cuda.synchronize()
            for (w, _, bT), g, p in zip(lc.classes, got, want):
                diff = u32_err(g, p)
                worst["X1_ladder_unpack"] = max(worst["X1_ladder_unpack"],
                                                diff)
                if not torch.equal(g, p):
                    fail(f"X1 disagrees with its plain version on {label}, "
                         f"w={w} {'pforb' if bT is not None else 'pfor'}, "
                         f"salt {s:#x} (max abs err {diff})")
    for label, packed in packs:
        got = ud.ladder_rows(packed)
        torch.cuda.synchronize()
        for w, a in packed.items():
            want = ud.ladder_rows_plain(a, w)
            diff = u32_err(got[w], want) if want.numel() else 0
            worst["X1_ladder_rows"] = max(worst["X1_ladder_rows"], diff)
            if not torch.equal(got[w], want):
                fail(f"X1's rows entry disagrees with its plain version on "
                     f"{label}, w={w} (max abs err {diff})")
    return worst


@contextlib.contextmanager
def plain_x1():
    """The ladder engines' chains with X1's plain version in the place of
    the launch: the torch-op chain (a shift, a mask and an add a class),
    for timing in turns beside X1."""
    from dint_tpu_torch.kernels import unpack_device as ud

    kernel = ud.ladder_unpack
    ud.ladder_unpack = lambda lc, salt: lc.plain(salt)
    try:
        yield
    finally:
        ud.ladder_unpack = kernel


def chain_in_turns(eng, runs: int, rounds: int = 2) -> dict:
    """ms a run of ``eng.chain(runs)`` through X1 and through the torch-op
    chain, in turns (X1, plain, X1, plain), CUDA events around each
    chain after one warm-up chain of each; the final checksums equal."""
    import torch

    def timed():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        salt = eng.chain(runs)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / runs, int(salt.item())

    int(eng.chain(2).item())
    with plain_x1():
        int(eng.chain(2).item())
    ms = {"x1": [], "plain": []}
    salts = set()
    for _ in range(rounds):
        t, s = timed()
        ms["x1"].append(t)
        salts.add(s)
        with plain_x1():
            t, s = timed()
        ms["plain"].append(t)
        salts.add(s)
    if len(salts) != 1:
        fail(f"the chain's checksum differs between X1 and the torch-op "
             f"chain: {sorted(salts)}")
    n = eng.plan.total_ints
    out = {"runs": runs, "rounds": rounds}
    for k, v in ms.items():
        out[f"{k}_ms_per_run"] = v
        out[f"{k}_ints_x_sec"] = n / (sum(v) / len(v) / 1e3)
    return out


def x1_bytes_ops(lc) -> tuple:
    """(bytes, integer operations) of one X1 launch over ``lc``: the words
    and bases read once, the salt, every output written once; a shift, a
    mask and an add a value."""
    outs = sum(o.numel() for o in lc.outs)
    reads = sum(wT.numel() + (bT.numel() if bT is not None else 0)
                for _, wT, bT in lc.classes)
    return 4 * (reads + outs) + 8, 3 * outs


def time_x1(lc, packed, errs, card_name) -> list:
    """Kernels-line entries of X1's two entries at the main path's shapes
    (the single_rect ladder engine's classes; the sharded pack of the
    same stream), each timed in turns with its plain version."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device="cuda")
    ms = time_in_turns({
        "X1_ladder_unpack": lambda: ud.ladder_unpack(lc, salt),
        "X1_ladder_unpack_plain": lambda: lc.plain(salt),
        "X1_ladder_rows": lambda: ud.ladder_rows(packed),
        "X1_ladder_rows_plain": lambda: {
            w: ud.ladder_rows_plain(a, w) for w, a in packed.items()},
    }, 50, flush)
    del flush
    nbytes, ops = x1_bytes_ops(lc)
    rows_out = sum(a.shape[0] * 256 for a in packed.values())
    rows_bytes = 4 * (sum(a.numel() for a in packed.values()) + rows_out)
    out = []
    for name, b, o, replaces, shape in (
            ("X1_ladder_unpack", nbytes, ops,
             "dint_tpu/kernels/unpack_device.py:952 (_fns; _fns_base :983, "
             "chained in UnpackEngine.timed_chain :1154)",
             [[w, int(wT.shape[1]) * 128, bT is not None]
              for w, wT, bT in lc.classes]),
            ("X1_ladder_rows", rows_bytes, 2 * rows_out,
             "dint_tpu/parallel/steps.py:319 (ladder_sharded_decode_step)",
             [[w, int(a.shape[0])] for w, a in packed.items()])):
        out.append({
            "name": name, "route": "cuda",
            "source": "dint_tpu_torch/kernels/csrc/ladder_unpack.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": ms[name + "_plain"],
            **bound_entry(b, o / INT32_OPS_PER_S * 1e3, card_name),
            "library_ms": None, "classes": shape,
        })
        log(f"{name} {ms[name] * 1e3:.2f} us (bound "
            f"{out[-1]['bound_ms'] * 1e3:.2f} us, plain "
            f"{ms[name + '_plain'] * 1e3:.1f} us)")
    return out


def x2_edge_arena(seed: int = 3):
    """(u64 words, specs, values) of EF lists written by the port's
    writer from a misaligned start: w = 0 (one value, a dense run), an
    empty list, a high region inside one word, values with bit 31 set
    (universes near 2^32), one list of many chunks beside short ones."""
    from dint_tpu_torch.codecs import ef
    from dint_tpu_torch.utils.bitio import BitBuilder

    rng = np.random.default_rng(seed)
    bb = BitBuilder()
    bb.append_bits(0x15, 5)
    specs, vals = [], []
    for n, universe in ((1, 1), (64, 64), (3, 9), (0, 100), (2, 40),
                        (7, (1 << 32) - 1), (1000, (1 << 31) + 77),
                        (400_000, 900_000), (33, 1 << 20), (1, 1 << 31)):
        v = np.zeros(0, np.uint64)
        if n == universe:
            v = np.arange(n, dtype=np.uint64)
        elif n:
            v = np.append(np.unique(rng.integers(
                0, universe - 1, 2 * n, dtype=np.uint64))[: n - 1],
                np.uint64(universe - 1))
        specs.append((bb.size, universe, n))
        if n:
            ef.compact_elias_fano.write(bb, v, universe, n, ef.PARAMS)
        vals.append(v)
    return bb.words(), specs, vals


def stream_values(data) -> np.ndarray:
    """The single_rect stream's values (the collection's gaps, stream
    order), decoded on the host by the native unit decoder."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.query import native_host
    from dint_tpu_torch.tools import decode

    stream, dict_file = data["single_rect_dint"]
    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary("single_rect_dint", dict_file).decode_view()
    lay = decode.units_from_meta(arena, meta, False)
    return native_host.decode_units_flat(view, arena, lay.starts,
                                         lay.byte_lens, lay.n, lay.ctx,
                                         lay.b_bits)


def shard_pack_on_card(flat: np.ndarray) -> dict:
    """``steps.ladder_shard_pack`` of ``flat`` for one rank, its classes
    on the card: what the sharded step's X1 launch reads."""
    from dint_tpu_torch.kernels import unpack_device as ud
    from dint_tpu_torch.parallel import steps

    packed, _, _, _ = steps.ladder_shard_pack(flat, 1)
    return {w: ud._u32_tensor(a[0], "cuda") for w, a in packed.items()}


def check_x2(label: str, tens) -> int:
    """X2 equal to its plain version on the card under torch.equal, on
    the uploaded tensors ``tens``; return max |kernel - plain|."""
    import torch

    from dint_tpu_torch.codecs import ef_device

    got = ef_device.decode_tensors(tens)
    want = ef_device.decode_tensors_plain(tens)
    torch.cuda.synchronize()
    diff = u32_err(got, want) if want.numel() else 0
    if not torch.equal(got, want):
        fail(f"X2 disagrees with its plain version on {label} "
             f"(max abs err {diff})")
    return diff


def check_x2_edges() -> int:
    """Phase 3's X2 check: the edge arena on the card, against the plain
    version and against the values written."""
    from dint_tpu_torch.codecs import ef, ef_device

    words, specs, vals = x2_edge_arena()
    tens = ef_device.upload(words, specs, ef.PARAMS, "cuda")
    diff = check_x2("the edge arena", tens)
    got = ef_device.decode_tensors(tens).cpu().numpy().view(np.uint32)
    if not np.array_equal(got, np.concatenate(vals).astype(np.uint32)):
        fail("X2 on the edge arena differs from the values written")
    return diff


# EF specs X2 cannot take safely, each refused by ef_device.prepare (and
# so by upload and decode_lists) before any upload
X2_REFUSED = ("n below its region's ones", "n twice the list's",
              "n half the list's", "a region shifted a bit",
              "a negative universe", "a negative n", "a negative offset",
              "an offset past the words", "an index cut short")


def x2_refused_specs(label: str):
    """(u64 words, specs) of the edge arena bent as ``label`` of
    ``X2_REFUSED`` says, on its list of 1,000 values (or, cut short, the
    words ending inside the list before the last)."""
    words, specs, _ = x2_edge_arena()
    k = next(i for i, s in enumerate(specs) if s[2] == 1000)
    off, universe, n = specs[k]
    bent = {"n below its region's ones": (off, universe, n - 1),
            "n twice the list's": (off, universe, 2 * n),
            "n half the list's": (off, universe, n // 2),
            "a region shifted a bit": (off + 1, universe, n),
            "a negative universe": (off, -1, n),
            "a negative n": (off, universe, -1),
            "a negative offset": (-off, universe, n),
            "an offset past the words": (64 * len(words), universe, n)}
    if label == "an index cut short":
        return words[: specs[-1][0] // 64], specs
    return words, specs[:k] + [bent[label]] + specs[k + 1 :]


def check_x2_refusals(device) -> int:
    """Every ``X2_REFUSED`` case refused by ``ef_device.upload`` and
    ``decode_lists`` on ``device`` with ValueError; a dict of tensors,
    and a table resized after its upload, refused by ``decode_tensors``;
    X2's launch count unchanged.  Returns the cases refused."""
    from dint_tpu_torch.codecs import ef, ef_device

    before = ef_device.decode_tensors.launches
    for label in X2_REFUSED:
        words, specs = x2_refused_specs(label)
        for entry in (ef_device.upload, ef_device.decode_lists):
            try:
                entry(words, specs, ef.PARAMS, device)
            except ValueError:
                continue
            fail(f"ef_device.{entry.__name__} took specs it must refuse: "
                 f"{label}")
    words, specs, _ = x2_edge_arena()
    t = ef_device.upload(words, specs, ef.PARAMS, device)
    loose = dict(t)
    t["lists"].resize_(1, 4)
    for label, bad in (("a dict", loose), ("a table resized", t)):
        try:
            ef_device.decode_tensors(bad)
        except ValueError:
            continue
        fail(f"ef_device.decode_tensors took {label}")
    if ef_device.decode_tensors.launches != before:
        fail("X2 launched while its tables were refused")
    return 2 * len(X2_REFUSED) + 2


def require_fused(counts, path: str, alone=()) -> None:
    """The engines of ``path`` ran the fused launch: it was launched,
    every class body ran in it, and no class kernel but those of
    ``alone`` was launched on its own.  On the CPU (a rehearsal) nothing
    is launched and nothing is asked."""
    import torch

    if not torch.cuda.is_available():
        return
    if counts[FUSED] <= 0:
        fail(f"the fused class launch was never launched on the {path} path")
    for name in DECODE_KERNELS:
        if counts[name + IN_FUSED] <= 0:
            fail(f"{name}'s body ran in no fused launch on the {path} path")
        if name not in alone and counts[name]:
            fail(f"{name} was launched on its own {counts[name]} times on "
                 f"the {path} path")


def require_x1(counts, path: str, want: int) -> None:
    """``path`` launched X1 exactly ``want`` times (one a chained run and
    one a whole decode); on the CPU (a rehearsal) none."""
    import torch

    got = counts[X1]
    if got != (want if torch.cuda.is_available() else 0):
        fail(f"{got} X1 launches on the {path} path, not {want}")


def drive_main_path(data, base, runs: int, device):
    """decode_stream for both types with the full collection check,
    through the gather image (the fused class launch) and through the
    ladder image (X1); return ({type: record}, {type: launch counts}),
    the ladder's under ``<type>/ladder``."""
    from dint_tpu_torch.tools import decode

    recs, counts = {}, {}
    for t in TYPES:
        stream, dict_file = data[t]
        reset_launch_counts()
        rec = decode.decode_stream(t, stream, dict_file, runs=runs,
                                   check_collection=base + ".docs",
                                   device=device)
        counts[t] = launch_counts()
        if rec.get("check") != "ok":
            fail(f"{t}: collection check did not pass")
        require_fused(counts[t], f"decode ({t})")
        # warm-up chain, timed chain, one decode_all: one launch a run
        # (none on the CPU, which launches nothing)
        if counts[t][FUSED] not in (0, 2 * runs + 1):
            fail(f"{t}: {counts[t][FUSED]} fused launches for {runs} runs, "
                 f"not {2 * runs + 1}")
        recs[t] = rec
    for t in TYPES:
        stream, dict_file = data[t]
        key = f"{t}/ladder"
        reset_launch_counts()
        rec = decode.decode_stream(t, stream, dict_file, runs=runs,
                                   check_collection=base + ".docs",
                                   engine="ladder", device=device)
        counts[key] = launch_counts()
        if rec.get("check") != "ok":
            fail(f"{key}: collection check did not pass")
        require_x1(counts[key], f"decode ({key})", 2 * runs + 1)
        recs[key] = rec
    return recs, counts


CELL_CONFIG = os.path.join(REPO, "benchmark", "configs", "gov2s-rect.json")


def cell_engine(root: str, seed: int, device="cuda"):
    """The benchmark cell's image on ``device`` (``CELL_CONFIG``: its
    collection from ``seed``, encoded and planned as the cell's set-up
    does it), under ``root``."""
    from benchmark import collection
    from dint_tpu_torch.dictionary import builder
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import common, decode, encode

    with open(CELL_CONFIG) as f:
        cfg = json.load(f)
    os.makedirs(root, exist_ok=True)
    base = os.path.join(root, "coll")
    stype = cfg["stream_type"]
    kind, policy = common.DINT_KINDS[stype]
    stream = os.path.join(root, f"coll.{stype}.bin")
    coll = collection.make(cfg["collection"], seed)
    collection.write(base, coll)
    encode.encode_collection(stype, base + ".docs", stream, cache_dir=root,
                             device=device)
    dict_file = os.path.join(root, builder.dict_cache_name(
        base + ".docs", kind, policy or "pack"))
    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary(stype, dict_file).decode_view()
    return decode.StreamDecoder(arena, meta, view, False, "local", None,
                                device).engine


def cell_phase(seed: int, card_name: str) -> dict:
    """Phase 32: the fused launch on the benchmark cell's image (90.9M
    postings), its trimmed classes against the same classes as padded
    triples (the reads of the launch before it took trimmed classes):
    equal in both flags, then in turns cold (behind an L2-clearing
    read) and chained as the benchmark runs it, each beside the bound
    of its own bytes."""
    import torch

    from dint_tpu_torch.kernels import decode_local as dl

    root = os.path.join(CACHE, "cell")
    eng = cell_engine(root, seed)
    forms = {"trimmed": fused_args(eng), "padded": fused_padded_args(eng)}
    for s in SALTS:
        st = torch.tensor([s], dtype=torch.int64, device="cuda")
        for exact in (False, True):
            a, b = (dl.decode_classes(*forms[k], st, exact, check=False)
                    for k in forms)
            if not torch.equal(a, b):
                fail(f"the cell's image decodes differently trimmed and "
                     f"padded, salt {s:#x}, exact={exact}")
    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device="cuda")
    buf = torch.empty((eng.rows, dl.N_OUT), dtype=torch.int32, device="cuda")
    cold = time_in_turns({k: (lambda a=a: dl.decode_classes(
        *a, salt, out=buf, check=False)) for k, a in forms.items()}, 40,
        flush, rounds=3)
    chained = {k: [] for k in forms}
    for _ in range(3):
        for k, a in forms.items():
            chained[k].append(chained_us(eng, a))
    rate = hbm_rate(card_name)
    rec = {"postings": eng.total_ints(), "rows": eng.rows,
           "card_bytes": eng.card_bytes(),
           "padded_card_bytes": fused_bytes(eng, forms["padded"])
           - eng.rows * dl.N_OUT * 4 - 8}
    for k in forms:
        nbytes = fused_bytes(eng, None if k == "trimmed" else forms[k])
        rec[k] = {"bytes": nbytes, "bound_us": nbytes / rate * 1e6,
                  "cold_us": cold[k] * 1e3,
                  "chained_us": sorted(chained[k])[1]}
    log(f"the cell's image: trimmed {rec['trimmed']['cold_us']:.2f} us cold "
        f"(bound {rec['trimmed']['bound_us']:.2f}), "
        f"{rec['trimmed']['chained_us']:.2f} chained; padded "
        f"{rec['padded']['cold_us']:.2f} (bound "
        f"{rec['padded']['bound_us']:.2f}), "
        f"{rec['padded']['chained_us']:.2f}; card image "
        f"{rec['card_bytes']} B against {rec['padded_card_bytes']} B")
    del eng, forms, buf, flush
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return rec


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
    require_fused(counts, "bench")
    if counts["K5_store_tile"] <= 0:
        fail("K5_store_tile was never launched on the bench path")
    # the two ladder legs: a warm-up and a timed chain, and one whole
    # decode, each
    require_x1(counts, "bench", 2 * (2 * RUNS + 1))
    return rec, legs, counts


def ladder_decoder(stream: str, dict_file: str, type_name: str):
    """The ladder image of a DINT stream on the card
    (``tools.decode.LadderStreamDecoder``)."""
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import decode

    arena, meta = stream_mod.load_stream(stream)
    view = decode.load_dictionary(type_name, dict_file).decode_view()
    return decode.LadderStreamDecoder(arena, meta, view,
                                      type_name.startswith("multi"),
                                      device="cuda")


def profile_ladder(data, card_name: str, trace_path: str):
    """Device-busy time of a chained ladder run of the single_rect image
    against its bytes bound (the image read once, 4 B an int written
    once), through X1 and through the torch-op chain; then both DINT
    ladder images chained in turns, X1 beside the torch-op chain."""
    from dint_tpu_torch.kernels import unpack_device as ud

    dec = ladder_decoder(*data["single_rect_dint"], "single_rect_dint")
    on_card = int(dec.engine.chain(3).item())
    on_host = int(ud.UnpackEngine(dec.engine.plan, device="cpu")
                  .chain(3).item())
    if on_card != on_host:
        fail(f"ladder chain salt {on_card:#x} on the card, {on_host:#x} on "
             "the host")
    out = {"chain_salt": on_card}
    for key in ("x1", "plain"):
        with plain_x1() if key == "plain" else contextlib.nullcontext():
            prof = profile_device(
                lambda: dec.engine.chain(LADDER_PROFILE_RUNS),
                LADDER_PROFILE_RUNS, trace_path.replace(".json",
                                                        f".{key}.json"))
        out[key] = prof
    nbytes = dec.plan_bytes + 4 * dec.engine.plan.total_ints
    out.update({"image_bytes": dec.plan_bytes,
                "classes": [[w, int(a0.shape[1]) * 128]
                            for _, w, a0, _ in dec.engine._dev],
                "bound_ms_per_run": nbytes / hbm_rate(card_name) * 1e3})
    del dec
    out["turns"] = {}
    for t in TYPES:
        dec = ladder_decoder(*data[t], t)
        out["turns"][t] = chain_in_turns(dec.engine, LADDER_TURN_RUNS)
        log(f"ladder chain {t} in turns: {out['turns'][t]}")
        del dec
    return out


K5_SHAPES = ((1024, 1024), (3000, 1000), (1001, 7), (96, 96))  # whole tiles
K5_RAGGED = ((2500, 1024), (37, 1024), (1000, 7))  # a last tile cut short


def check_k5(num_integers: int, card_name: str) -> dict:
    """Phase 6: K5 against its plain version at the bench output size,
    at one tile, at tile heights that are no power of two and (through
    its C entry; the wrapper keeps whole tiles) with a last tile cut
    short; its chain against the plain chain; its time in turns with
    ``fill_`` on the same bytes.  Returns its kernels-line entry."""
    import torch

    from dint_tpu_torch.kernels import cuda_ext
    from dint_tpu_torch.kernels import store_probe as sp

    rows = sp.probe_rows(num_integers * 4)
    entry_c = cuda_ext.lib("libdintprobe.so").dint_store_tile
    stream = torch.cuda.current_stream().cuda_stream
    worst = 0
    for r, rt in ((rows, 1024),) + K5_SHAPES + K5_RAGGED:
        for s in SALTS:
            st = sp.salt_tensor(s, "cuda")
            if r % rt:
                got = torch.full((r, sp.ROW_LANES), -7, dtype=torch.int32,
                                 device="cuda")
                rc = entry_c(st.data_ptr(), got.data_ptr(), r, rt, stream)
                cuda_ext.check("libdintprobe.so", "dint_store_tile", rc)
            else:
                got = sp.store_tile(st, r, rt)
            want = sp.store_tile_plain(st, r, rt)
            torch.cuda.synchronize()
            worst = max(worst, u32_err(got, want))
            if not torch.equal(got, want):
                fail(f"K5 disagrees with its plain version at {r} rows, "
                     f"tiles of {rt}, salt {s:#x}")
    on_card = int(sp.probe_chain(2048, 1024, 3, torch.device("cuda")).item())
    on_host = int(sp.probe_chain(2048, 1024, 3, torch.device("cpu")).item())
    if on_card != on_host:
        fail(f"probe chain salt {on_card} on the card, {on_host} on the host")
    log(f"K5 equals its plain version at {rows} rows, {K5_SHAPES} and "
        f"ragged {K5_RAGGED}; chain salt {on_card & MASK:#x} on both")
    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    st = sp.salt_tensor(0x9E3779B9, "cuda")
    buf = torch.empty((rows, sp.ROW_LANES), dtype=torch.int32, device="cuda")
    fns = {"K5": lambda: sp.store_tile(st, rows, out=buf),
           "fill_": lambda: buf.fill_(7)}
    ms = time_in_turns(fns, 50, flush, rounds=3)
    entry = {
        "name": "K5_store_tile",
        "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/store_probe.cu",
        "replaces": "dint_tpu/kernels/store_probe.py:48 (kernel :37 in "
                    "_probe_fns :32)",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms["K5"],
        "plain_ms": time_ms(lambda: sp.store_tile_plain(st, rows), 5, flush),
        **bound_entry(rows * sp.ROW_LANES * 4 + 4,
                      4 * rows * sp.ROW_LANES / INT32_OPS_PER_S * 1e3,
                      card_name),
        "library_ms": ms["fill_"],
        "rows": rows,
    }
    log(f"K5 {entry['ms'] * 1e3:.2f} us, fill_ "
        f"{entry['library_ms'] * 1e3:.2f} us, bound "
        f"{entry['bound_ms'] * 1e3:.2f} us (in turns, 3 rounds)")
    return entry


def onehot_edge_batch(rows: int = 256, seed: int = 11):
    """K6/K7 inputs on the card that force the edge cases: table words
    with bit 31 set, n = 0, 1 and 256, indices outside [0, 256) (one row
    holds nothing else), and rows that repeat one index 256 times."""
    import torch

    rng = np.random.default_rng(seed)
    vidx = rng.integers(0, 256, (rows, 256)).astype(np.int32)
    vidx[3, 5], vidx[4, 7], vidx[9, 0], vidx[9, 255] = 300, -1, 256, 2**31 - 1
    vidx[4, 0], vidx[5] = -(2**31), 256
    vidx[6], vidx[7], vidx[8] = 0, 255, 77
    vidx[12], vidx[13] = 16, -1  # with n = 256 further down the batch
    vidx[20] = 131
    tab = rng.integers(0, 1 << 32, (rows, 256), dtype=np.uint64)
    tab[:, ::7] |= 0x80000000
    n = rng.integers(0, 257, rows).astype(np.int32)
    n[:10] = 256
    n[10], n[11], n[12], n[13] = 0, 1, 256, 256
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
    require_fused(counts, "ablation", alone=("K1_gather32",))
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
    # K6, K7, K1 and the library gather on the same rows, in turns
    vi64 = vi.to(torch.int64)
    ms = time_in_turns({
        "K6_onehot_block": lambda: dp.decode_gather_pallas(vi, tbl, nn, st),
        "K7_onehot_group": lambda: dp.decode_gather_pallas_grid(vi, tbl, nn,
                                                                st),
        "K1_gather32": lambda: dl.gather32(v8, tbl, nn, st),
        "library_gather": lambda: torch.gather(tbl, 1, vi64)}, 10, flush)
    k1_ms = ms["K1_gather32"]
    rate = hbm_rate(card_name)
    rec["same_rows"] = {
        "rows": R,
        "K1_gather32_ms": k1_ms,
        "K1_bound_ms": kernel_bytes_ops("K1_gather32", R, 256)[0] / rate * 1e3,
        "library_gather_ms": ms["library_gather"],
    }
    entries = []
    for name, _, line, body in kernels:
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "dint_tpu_torch/kernels/csrc/onehot_gather.cu",
            "replaces": f"dint_tpu/kernels/decode_pallas.py:{line} ({body})",
            "launches": counts[name],
            "launches_by_path": {"ablate": counts[name]},
            "max_abs_err": errs[name],
            "ms": ms[name],
            "plain_ms": plain_ms,
            **bound_entry(R * (3 * 1024 + 4) + 8,
                          2 * 4 * 256 * 256 * R / INT8_TENSOR_OPS_PER_S * 1e3,
                          card_name),
            "library_ms": ms["library_gather"],
            "library_call": LIBRARY_GATHER,
            "rows": R,
            # what the product reads from shared memory: 32 wgmma a row,
            # each a 2 KiB selector tile and a 256 B plane tile, at 128 B
            # a clock and multiprocessor (boost clock)
            "smem_bound_ms": R * 32 * (2048 + 256) / (SMS * 128 * SM_HZ) * 1e3,
        })
        rec["same_rows"][name + "_ms"] = entries[-1]["ms"]
        log(f"{name} {entries[-1]['ms'] * 1e3:.1f} us on {R} rows (bound "
            f"{entries[-1]['bound_ms'] * 1e3:.1f} us, shared-memory bound "
            f"{entries[-1]['smem_bound_ms'] * 1e3:.1f} us, K1 {k1_ms * 1e3:.1f} us, "
            f"torch.gather {ms['library_gather'] * 1e3:.1f} us, "
            f"plain {plain_ms:.1f} ms)")
    return rec, counts, entries


# ---------------------------------------------------------------------------
# Serving: data, main path, K4, exactness
# ---------------------------------------------------------------------------


def kernel_modules():
    """The modules whose wrappers count their launches."""
    from dint_tpu_torch.codecs import ef_device
    from dint_tpu_torch.kernels import (decode_local, decode_pallas,
                                        decode_xla, store_probe,
                                        unpack_device)
    from dint_tpu_torch.query import device_serve

    return (decode_local, device_serve, store_probe, decode_pallas,
            unpack_device, ef_device, decode_xla)


def reset_launch_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def launch_counts():
    """{wrapper: launches of its kernel}; under ``<K1-K3> + IN_FUSED``,
    the fused launches whose grid ran that class's body, and under
    ``WALKED`` those of more tiles than the card holds blocks at once
    (``decode_classes.walked``), under ``TRIMMED`` those that read a
    class trimmed (``decode_classes.trimmed``)."""
    out = {}
    for m in kernel_modules():
        out.update(m.launch_counts())
    dl = kernel_modules()[0]
    out.update({k + IN_FUSED: v for k, v in dl.fused_body_counts().items()})
    out[WALKED] = dl.decode_classes.walked
    out[TRIMMED] = dl.decode_classes.trimmed
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
    (ranked_or, then wand and maxscore through the pruned fused store,
    then and/or).  Returns (state, {op: record},
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
    # ranked_or once more after the pruned ops: the two unpruned timings
    # bracket the pruned ones, so a drift of the host shows
    for name, r in ([(op, runs) for op in RANKED_OPS + (RANKED_AGAIN,)]
                    + [("and", bool_runs), ("or", bool_runs)]):
        op = "ranked_or" if name == RANKED_AGAIN else name
        k4_before = device_serve.block_copy.launches
        stats, shape, extra = qtool.run_op_device(index, dec, wdata, qs, op,
                                                  r, TOPK, store=store)
        recs[name] = {"type": op, **stats, "runs": r,
                    "queries_per_s": 1e6 / stats["avg"],
                    "batch_shape": "x".join(map(str, shape)), **extra,
                    "k4_launches":
                        device_serve.block_copy.launches - k4_before}
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


def check_topk(qs, oracle, out_s, out_d, what: str) -> float:
    """Every query's top-k scores equal the oracle's, with as many
    results, and the returned docids carry their scores; returns the
    worst relative score error."""
    worst = 0.0
    for i, q in enumerate(qs):
        want, ud, sums = oracle[i]
        got = out_s[i]
        if got.shape != want.shape or not np.allclose(got, want, rtol=RTOL,
                                                      atol=ATOL):
            fail(f"{what} query {i} {q}: scores {got} != oracle {want}")
        pos = np.searchsorted(ud, out_d[i].astype(np.int64))
        pos = np.minimum(pos, max(ud.shape[0] - 1, 0))
        if got.size and not (np.array_equal(ud[pos], out_d[i])
                             and np.allclose(sums[pos], got, rtol=RTOL,
                                             atol=ATOL)):
            fail(f"{what} query {i} {q}: returned docids do not carry "
                 "their scores")
        if want.size:
            worst = max(worst, float(np.max(np.abs(got - want)
                                             / np.maximum(np.abs(want),
                                                          1e-30))))
    return worst


def check_serving(base: str, state):
    """Phase 11: decoded lists, ranked top-k (unpruned, and pruned as
    wand and maxscore serve it) and boolean counts against the
    collection files; returns a summary.  The lists checked are every
    term's, as the store build decoded them on the card (the decoder's
    cache)."""
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
    norm = np.asarray(state["wdata"].norm_lens, np.float32)
    oracle = [oracle_topk(docs, freqs, norm, num_docs, q) for q in qs]
    state["oracle"] = oracle
    out_s, out_d, _ = store.ranked_topk(qs, k=TOPK, prune=False)
    worst = check_topk(qs, oracle, out_s, out_d, "ranked_or")
    out_s, out_d, pst = store.ranked_topk(qs, k=TOPK, prune=True,
                                          lazy_cache=dec.lazy_cache)
    worst_pruned = check_topk(qs, oracle, out_s, out_d, "pruned")
    if not pst["blocks_kept"] < pst["blocks_total"]:
        fail(f"pruning removed no block: {pst}")
    state["pruned"] = (out_s, out_d)
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
        state[f"{op}_counts"] = got
    return {"queries": len(qs), "terms_checked": len(terms),
            "max_rel_score_err": worst,
            "max_rel_score_err_pruned": worst_pruned,
            "blocks_kept": pst["blocks_kept"],
            "blocks_total": pst["blocks_total"], "total_results": counts}


def check_survival(state):
    """The survival pass on the card, on the log's own events (tau
    hinted from the store's tables, as the pruned serve path does):
    against a float64 numpy replay of the pointwise bound (fail if the
    card prunes a block the replay keeps; count what it keeps that the
    replay prunes) and against the same function on the CPU (count the
    differing mask bytes).  Also times the metadata pass's parts."""
    import torch

    from dint_tpu_torch.query import bmw_device, ranked

    index, wdata, store = state["index"], state["wdata"], state["store"]
    qs, cache = state["queries"], state["decoder"].lazy_cache
    weighted = [ranked._query_weights(index, q) for q in qs]
    multi = [qi for qi, w in enumerate(weighted) if len(w) != 1]
    t = {}
    t0 = time.perf_counter()
    hints = [store.tau_from_tables(weighted[qi], TOPK) for qi in multi]
    t["tau_hints_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_q, taus, P = bmw_device.plan_batch(
        cache, index, wdata, [qs[qi] for qi in multi], TOPK, hints)
    t["plan_s"] = time.perf_counter() - t0
    dev_rows = [i for i, p in enumerate(per_q)
                if p is not None and p[0] == "dev"]
    rows = [per_q[i][2] for i in dev_rows]
    t0 = time.perf_counter()
    ev = bmw_device.build_events(rows, P)
    t["event_build_s"] = time.perf_counter() - t0
    tau = np.asarray([taus[i] for i in dev_rows], np.float64)
    T = max(len(g) for g in rows)

    def run(device):
        up = [torch.from_numpy(a).to(device) for a in (*ev, tau)]
        return bmw_device.survival(*up, T).cpu().numpy()

    dev = store.device
    run(dev)  # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = run(dev)
    t["survival_card_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_cpu = min(len(rows), 64)  # the CPU run is (T, rows, P) float64
    up = [torch.from_numpy(a[:n_cpu]) for a in (*ev, tau)]
    cpu = bmw_device.survival(*up, T).numpy()
    differ = int((got[:n_cpu] != cpu).sum())
    t0 = time.perf_counter()
    keeps = bmw_device.unpack_masks(got, ev[0], ev[1], ev[3], rows)
    t["mask_unpack_s"] = time.perf_counter() - t0
    bound = pointwise_bound_replay(*ev, rows)
    lost = extra = total = kept = 0
    for keep, b, tq in zip(keeps, bound, tau):
        for term, m in keep.items():
            want = b[term] >= tq
            lost += int((want & ~m).sum())
            extra += int((m & ~want).sum())
            total += m.shape[0]
            kept += int(m.sum())
    if lost:
        fail(f"the card pruned {lost} blocks that the float64 replay of "
             "the pointwise bound keeps")
    torch.cuda.empty_cache()
    out = {"device_queries": len(rows), "event_width": P, "slots": T,
           "blocks": total, "blocks_kept": kept,
           "pruned_but_kept_by_replay": lost,
           "kept_but_pruned_by_replay": extra,
           "mask_bytes_differing_from_cpu": differ,
           "rows_compared_with_cpu": n_cpu,
           "survival_peak_bytes": peak, **t}
    log(f"survival pass: {out}")
    return out


def check_host_engine(state):
    """The host engine on the log's first queries, one pass: wand and
    maxscore against the device engine's pruned top-k, ranked_and
    against the oracle's sums over the device engine's AND members, and
    the lazy and/or against the device counts; then each op once
    through ``tools.queries.run_op``."""
    from dint_tpu_torch.query import (boolean, device_batch, lazy_decode,
                                      ranked)
    from dint_tpu_torch.tools import queries as qtool

    index, wdata, dec = state["index"], state["wdata"], state["decoder"]
    qs = state["queries"][:HOST_QUERIES]
    dev_s, _ = state["pruned"]
    members = device_batch.and_results_batch(dec, qs)
    shared = dec._lazy_cache
    t0 = time.perf_counter()
    for i, q in enumerate(qs):
        for op in ("wand", "maxscore"):
            dec._lazy_cache = lazy_decode.BlockCache(index)
            got = getattr(ranked, op)(index, dec, wdata, q, TOPK)
            if got.shape != dev_s[i].shape or not np.allclose(
                    got, dev_s[i], rtol=RTOL, atol=ATOL):
                fail(f"host {op} query {i} {q}: {got} != device {dev_s[i]}")
        dec._lazy_cache = lazy_decode.BlockCache(index)
        got = ranked.ranked_and(index, dec, wdata, q, TOPK)
        _, ud, sums = state["oracle"][i]
        pos = np.searchsorted(ud, members[i].astype(np.int64))
        want = np.sort(sums[pos])[::-1][:TOPK].astype(np.float32)
        if got.shape != want.shape or not np.allclose(got, want, rtol=RTOL,
                                                      atol=ATOL):
            fail(f"host ranked_and query {i} {q}: {got} != {want}")
        cache = lazy_decode.BlockCache(index)
        n_and = boolean.and_query_lazy(cache, q).shape[0]
        n_or = boolean.or_query_lazy(cache, q).shape[0]
        if (n_and, n_or) != (int(state["and_counts"][i]),
                             int(state["or_counts"][i])):
            fail(f"host and/or query {i} {q}: {(n_and, n_or)} != device")
    check_s = time.perf_counter() - t0
    recs = {}
    for op in HOST_OPS:
        stats = qtool.run_op(index, dec, wdata, qs, op, 1, TOPK)
        recs[op] = {**stats, **(dec._lazy_totals or {})}
        log(f"host engine {op}: {recs[op]}")
    dec._lazy_cache = shared
    return {"queries": len(qs), "check_s": check_s, "records": recs}


def pointwise_bound_replay(docid, is_end, delta, slot, rows):
    """A float64 numpy replay of the pointwise bound on one batch's
    event arrays (in build order, as ``bmw_device.build_events`` lays
    them out: a slot's starts, then its ends, block order inside each).
    U(x) is the sum of the deltas of every event at a docid <= x; a
    block's value is the maximum of U over the docids of its span.  No
    tie order, no scan, no running maximum: it shares nothing with the
    survival pass but the events.  Returns per row {term: max U per
    block}."""
    out = []
    for r, geoms in enumerate(rows):
        n = int((slot[r] != 255).sum())
        d = docid[r, :n].astype(np.int64)
        order = np.argsort(d, kind="stable")
        pts, first = np.unique(d[order], return_index=True)
        cs = np.cumsum(delta[r, :n].astype(np.float64)[order])
        last = np.concatenate([first[1:], [n]]) - 1
        U = np.concatenate([cs[last], [-np.inf]]) if n else np.zeros(1)
        res, pos = {}, 0
        for t, (lo, _, _) in geoms:
            nb = lo.shape[0]
            i0 = np.searchsorted(pts, d[pos:pos + nb], side="left")
            i1 = np.searchsorted(pts, d[pos + nb:pos + 2 * nb], side="left")
            pairs = np.stack([i0, i1], axis=1).reshape(-1)
            res[t] = (np.maximum.reduceat(U, pairs)[0::2] if nb
                      else np.zeros(0))
            pos += 2 * nb
        out.append(res)
    return out


def check_serve_classes(kept, counts):
    """K1-K3 against their twins, and the fused launch against its plain
    version in both flags, on the class tensors of the engines the
    serve path built (the docid and freq class splits); every class
    body that ran there must have been checked.  Returns {kernel name:
    max abs err}."""
    cases = {}
    for e in kept:
        class_cases(e, cases)
        log("serve engine classes: " + ", ".join(
            f"{c.mode}: {c.rows} rows" for c in e._classes if c.rows))
    for _, name, _, _ in class_kernels():
        if counts[name + IN_FUSED] and name not in cases:
            fail(f"{name} ran on the serve path but no class was kept")
    errs = check_kernels(cases)
    errs[FUSED] = check_fused(
        [(f"serve engine {i}", fused_args(e)) for i, e in enumerate(kept)])
    return errs


def serve_phases(base: str, paths, card_name: str, trace_path: str):
    """Phases 9-14 on the card: the serving main path with launches
    counted from zero, K1-K3 against their twins on that path's class
    tensors, K4 against its plain version and its times, exactness
    unpruned and pruned, the survival pass against its replay, the host
    engine, and the profiler.  Returns a summary with the launch counts, the serve
    path's K1-K3 errors, K4's kernels-line entry and the records."""
    import torch

    kept = []
    reset_launch_counts()
    with keep_engines(kept):
        state, recs, times = drive_serve_path(paths, SERVE_RUNS, BOOL_RUNS)
    counts = launch_counts()
    log(f"serve path launches: {counts}")
    require_fused(counts, "serve")
    if counts["K4_block_copy"] <= 0:
        fail("K4_block_copy was never launched on the serve path")
    class_errs = check_serve_classes(kept, counts)
    log(f"K1-K3 and the fused launch equal their plain versions on the "
        f"serve path's classes: {class_errs}")
    del kept
    torch.cuda.empty_cache()
    store = state["store"]
    buckets, _, _ = store._batch_metadata(state["queries"], TOPK,
                                          prune=False)
    dev_buckets, _ = store.upload(buckets)
    t0 = time.perf_counter()
    pbuckets, _, pstats = store._batch_metadata(
        state["queries"], TOPK, prune=True,
        lazy_cache=state["decoder"].lazy_cache)
    pruned_meta_s = time.perf_counter() - t0
    pruned_dev_buckets, _ = store.upload(pbuckets)
    want_k4 = {"ranked_or": len(buckets), "wand": len(pbuckets),
               "maxscore": len(pbuckets), RANKED_AGAIN: len(buckets)}
    for op in want_k4:
        if recs[op]["k4_launches"] != want_k4[op] * (SERVE_RUNS + 1):
            fail(f"{op}: K4 launched {recs[op]['k4_launches']} times, not "
                 f"once per bucket ({want_k4[op]}) per pass "
                 f"({SERVE_RUNS + 1})")
    if counts["K4_block_copy"] != sum(recs[op]["k4_launches"]
                                      for op in want_k4):
        fail(f"K4 launched {counts['K4_block_copy']} times on the serve "
             "path, more than its ranked ops account for")
    for op in ("wand", "maxscore"):
        if not (int(recs[op]["blocks_kept"]) == pstats["blocks_kept"]
                < int(recs[op]["blocks_total"]) == pstats["blocks_total"]):
            fail(f"{op} pruned nothing, or not what the store prunes: "
                 f"{recs[op]['blocks_kept']} of {recs[op]['blocks_total']} "
                 f"kept, the store {pstats}")
    k4_err = check_k4(store, k4_cases(store, dev_buckets)
                      + [(f"pruned P={P} G={blk.shape[0]}", blk, qw)
                         for P, _, blk, qw, _ in pruned_dev_buckets])
    log(f"K4 equals its plain version at {len(dev_buckets)} bucket shapes "
        f"and {len(K4_EDGE_G)} edge batches")
    exact = check_serving(base, state)
    log(f"serving exact: {exact}")
    survival = check_survival(state)
    host = check_host_engine(state)
    log(f"host engine agrees with the device engine on {host['queries']} "
        f"queries ({host['check_s']:.1f} s)")
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
    k4["launches_by_op"] = {op: recs[op]["k4_launches"] for op in want_k4}
    prof = profile_device(
        lambda: [store.serve(dev_buckets, TOPK)
                 for _ in range(PROFILE_PASSES)],
        PROFILE_PASSES, trace_path)
    pruned_prof = profile_device(
        lambda: [store.serve(pruned_dev_buckets, TOPK)
                 for _ in range(PROFILE_PASSES)],
        PROFILE_PASSES, trace_path.replace(".json", "_pruned.json"))
    torch.cuda.synchronize()
    index = state["index"]
    ids = np.concatenate([blk[blk != store.NB - 1]
                          for _, blk, _, _ in pbuckets.values()])
    term = np.searchsorted(store.blk_off, ids, side="right") - 1
    kept_postings = int(np.minimum(
        256, index.list_n[term].astype(np.int64)
        - 256 * (ids - store.blk_off[term])).sum())
    shapes_of = lambda bs: [[P, len(idxs)] for P, idxs, *_ in bs]
    pruned = {
        **{op: {key: recs[op][key] for key in ("avg", "q50", "q90", "q95")}
           for op in want_k4},
        "blocks_kept": pstats["blocks_kept"],
        "blocks_total": pstats["blocks_total"],
        "postings_kept": kept_postings,
        "postings_total": sum(int(index.list_n[t]) for q in state["queries"]
                              if len(set(q)) > 1 for t in set(q)),
        **{key: pstats[key] for key in ("device_queries",
                                        "host_fallback_queries",
                                        "event_width")},
        "prune_rows_host_s": {op: recs[op]["prune_rows_host_s"]
                              for op in RANKED_OPS},
        "pruned_metadata_s": pruned_meta_s,
        "buckets_unpruned": shapes_of(dev_buckets),
        "buckets_pruned": shapes_of(pruned_dev_buckets),
        "lanes_unpruned": sum(P * len(i) for P, i, *_ in dev_buckets),
        "lanes_pruned": sum(P * len(i) for P, i, *_ in pruned_dev_buckets),
        "device_busy_ms_per_pass_unpruned": prof["device_busy_ms_per_run"],
        "device_busy_ms_per_pass_pruned":
            pruned_prof["device_busy_ms_per_run"],
        "wall_ms_per_pass_unpruned": prof["wall_ms_per_run"],
        "wall_ms_per_pass_pruned": pruned_prof["wall_ms_per_run"],
        "survival": survival,
    }
    return {"records": recs, "host_s": times, "launches": counts,
            "class_errs": class_errs, "exact": exact,
            "oracle": state["oracle"],
            "bool_counts": {op: state[f"{op}_counts"] for op in ("and", "or")},
            "store_bytes": store.store_bytes, "store_rows": store.NB,
            "k4": k4, "profile": prof, "pruned_profile": pruned_prof,
            "pruned": pruned, "host_engine": host}


# ---------------------------------------------------------------------------
# The raw chain-scan engine and the zoo
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# X3 (the raw decode of a pass) and X4 (the byte-class wire unpack)
# ---------------------------------------------------------------------------


def x3_view(seed: int = 17, contexts: int = 2, table_words: int = 5000):
    """(lengths, offsets u32, table u32) of a dictionary that holds every
    entry length 0-16, the five runs 16-256 at EXCEPTIONS.., entries of
    16 words, zero-length entries, table words with bit 31 set, and
    offsets past the table, past 2^31 (the index wraps, then is clamped)
    and just below 2^31 on 16-word entries (offset + k wraps in int32)."""
    from dint_tpu_torch.config import EXCEPTIONS, NUM_ENTRIES

    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 17, size=(contexts, NUM_ENTRIES)).astype(
        np.int32)
    lengths[:, EXCEPTIONS : EXCEPTIONS + 5] = (256, 128, 64, 32, 16)
    lengths[:, 7:40] = 16
    lengths[:, 40:60] = 0
    lengths[:, 85:90] = 16
    lengths[:, :EXCEPTIONS] = 1
    offsets = rng.integers(0, table_words - 16,
                           size=(contexts, NUM_ENTRIES)).astype(np.uint32)
    offsets[:, 60:70] = table_words + rng.integers(0, 40, 10)
    offsets[:, 70:80] = (1 << 32) - rng.integers(1, 20, 10)
    offsets[:, 80:85] = (1 << 31) + rng.integers(0, 20, 5)
    offsets[:, 85:90] = (1 << 31) - rng.integers(1, 16, 5)
    table = rng.integers(0, 1 << 32, size=table_words + 16,
                         dtype=np.uint64).astype(np.uint32)
    table[-16:] = 0
    return lengths, offsets, table


def x3_walk_rows(b: int, rows: int, W: int, seed: int):
    """(cw, w_valid) of ``rows`` token rows a walk decodes: codewords
    (runs, 16-word, zero-length and other entries, offsets that wrap),
    both exception markers with their payload tokens, an exception as
    some rows' last codeword, noise past w_valid."""
    from dint_tpu_torch.config import EXCEPTIONS
    from dint_tpu_torch.kernels import decode_xla as dx

    rng = np.random.default_rng(seed)
    top = 1 << b
    _, small, large = dx._steps_for(b)
    cw = np.zeros((rows, W), np.int32)
    w_valid = np.zeros(rows, np.int32)
    for r in range(rows):
        q, limit = 0, int(rng.integers(1, W + 1))
        while q < limit:
            u = rng.random()
            if u < 0.15:
                step, mark = small, 0
            elif u < 0.25:
                step, mark = large, 1
            else:
                step = 1
                mark = int(rng.choice([rng.integers(EXCEPTIONS, 7),
                                       rng.integers(7, 90),
                                       rng.integers(EXCEPTIONS, top)]))
            if q + step > W:
                break
            cw[r, q] = mark
            cw[r, q + 1 : q + step] = rng.integers(0, top, step - 1)
            q += step
        if r % 3 == 0 and q + large <= W:
            cw[r, q] = 1
            cw[r, q + 1 : q + large] = rng.integers(0, top, large - 1)
            q += large
        w_valid[r] = q
        cw[r, q:] = rng.integers(0, top, W - q)
    return cw, w_valid


# X3's edges: a block row thread's run of 4 tokens, a warp row's chunk of
# 64 (32 runs of 2), a block row's warp of 128 and its chunk of 1024, and
# two such chunks
X3_EDGES = (4, 64, 128, 1024, 2048)


def x3_straddle_rows(b: int, W: int = 2053, edges=X3_EDGES):
    """(cw, w_valid): rows whose exception ends at an edge plus o, for
    o = 0 .. D - 1, both markers, at each of ``edges`` below W (X3's
    thread runs, warp scans and chunks); W no multiple of 32."""
    from dint_tpu_torch.kernels import decode_xla as dx

    _, small, large = dx._steps_for(b)
    rows, wv = [], []
    for edge in edges:
        for mark, step in ((0, small), (1, large)):
            for o in range(large):
                p = edge + o - step
                if p < 0 or edge + large >= W:
                    continue
                r = np.full(W, 9, np.int32)
                r[p] = mark
                r[p + 1 : p + step] = (1 << b) - 1 - np.arange(step - 1)
                rows.append(r)
                wv.append(W - o)
    return np.stack(rows), np.asarray(wv, np.int32)


def x3_edge_tiles(seed: int = 13):
    """[(label, (cw, w_valid, n, ctx, lengths, offsets, table) numpy,
    b, n_out, assume_clean)]: X3's edge cases at b = 16 and 8, dirty and
    clean, W no multiple of 32, w_valid 0 and 1, n below and above what
    a row produces, n = 0 and n_out, exceptions across X3's run, warp and
    chunk edges in rows a warp takes and rows a block takes, runs, one
    dictionary for all (so that they also make one mixed pass)."""
    from dint_tpu_torch.config import EXCEPTIONS

    lengths, offsets, table = x3_view(seed)
    rng = np.random.default_rng(seed)
    cases = []

    def add(label, cw, wv, b, n_out, clean, n=None):
        B = cw.shape[0]
        if n is None:
            n = rng.integers(0, n_out + 1, B).astype(np.int32)
            n[: min(B, 3)] = (0, n_out, 1)[: min(B, 3)]
        ctx = (np.arange(B) % lengths.shape[0]).astype(np.int32)
        cases.append((label, (cw, wv, n.astype(np.int32), ctx, lengths,
                              offsets, table), b, n_out, clean))

    for b in (16, 8):
        cw, wv = x3_walk_rows(b, 45, 101, seed + b)
        wv[3], wv[4] = 0, 1
        add(f"b={b} dirty W=101", cw, wv, b, 256, False)
        cw, wv = x3_walk_rows(b, 9, 1000, seed + 2 * b)
        add(f"b={b} dirty W=1000", cw, wv, b, 1024, False,
            n=np.full(9, 700, np.int32))
        cw, wv = x3_walk_rows(b, 5, 5000, seed + 3 * b)
        add(f"b={b} dirty W=5000", cw, wv, b, 4096, False,
            n=np.asarray([4096, 3000, 1, 0, 2500], np.int32))
        for W, edges in ((2053, X3_EDGES), (205, X3_EDGES[:3])):
            cw, wv = x3_straddle_rows(b, W, edges)
            add(f"b={b} chunk-edge exceptions W={W}", cw, wv, b, 1024, False,
                n=np.full(cw.shape[0], 1024, np.int32))
        cw = rng.integers(EXCEPTIONS, 1 << b, size=(37, 70)).astype(np.int32)
        cw[:, ::5] = rng.integers(EXCEPTIONS, 90, size=cw[:, ::5].shape)
        wv = rng.integers(0, 71, 37).astype(np.int32)
        wv[:3] = (0, 1, 70)
        add(f"b={b} clean W=70", cw, wv, b, 256, True)
        cw = rng.integers(EXCEPTIONS, 90, size=(4, 3000)).astype(np.int32)
        add(f"b={b} clean W=3000", cw, np.asarray([3000, 2049, 2048, 5],
                                                  np.int32), b, 8192, True)
        runs = np.where(rng.random((6, 100)) < 0.5,
                        rng.integers(EXCEPTIONS, EXCEPTIONS + 5, (6, 100)),
                        rng.integers(7, 40, (6, 100))).astype(np.int32)
        wv = np.asarray([100, 100, 50, 3, 1, 33], np.int32)
        for clean in (False, True):
            add(f"b={b} runs, clean={clean}", runs, wv, b, 4096, clean,
                n=np.asarray([4096, 100, 4000, 300, 256, 8192], np.int32))
    return cases


def x3_edge_pass(device):
    """Every ``x3_edge_tiles`` case as one mixed pass (b 16 and 8, clean
    and dirty, rows a warp and rows a block take) on ``device``: (labels,
    PassTable)."""
    import torch

    from dint_tpu_torch.kernels import decode_xla as dx

    cases = x3_edge_tiles()
    lengths, offsets, table = cases[0][1][4:]
    up = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).view(np.int32)).to(device)
    tiles = [(cw, wv, n, ctx, b, n_out, clean)
             for _, (cw, wv, n, ctx, *_d), b, n_out, clean in cases]
    return ([c[0] for c in cases],
            dx.pass_table(tiles, up(lengths), up(offsets), up(table)))


# PassTable inputs X3 cannot take safely, each refused before any upload
X3_REFUSED = ("out0 past slots", "two tiles on one row0",
              "a row in no tile", "overlapping slots",
              "overlapping tokens past the buffer")


def x3_refused_case(label: str, device):
    """A call of ``decode_xla.PassTable`` that must raise ValueError: a
    valid two-tile pass on ``device`` (rows 0-2 b = 16 dirty, rows 3-4 b =
    8 clean, 64 tokens and 128 slots a row) with its specs bent as
    ``label`` of ``X3_REFUSED`` says (the specs' rows sum to R, so a row
    in no tile comes with a tile past R or two tiles on one row); "out0
    past slots" is a one-tile pass of two 4-token rows whose slots start
    at 10^9, where ``slots`` is 16."""
    import torch

    from dint_tpu_torch.kernels import decode_xla as dx

    rng = np.random.default_rng(23)
    lengths, offsets, table = x3_view()
    tiles = []
    for b, rows, clean in ((16, 3, False), (8, 2, True)):
        cw, wv = x3_walk_rows(b, rows, 64, seed=b)
        tiles.append((cw, wv, rng.integers(0, 129, rows).astype(np.int32),
                      np.zeros(rows, np.int32), b, 128, clean))
    pt = dx.pass_table(tiles, *(torch.from_numpy(a.view(np.int32)).to(device)
                                for a in (lengths, offsets, table)))
    a, b = pt.specs
    tens = [pt.tokens, pt.w_valid, pt.n, pt.ctx]
    if label == "out0 past slots":
        tens = [pt.tokens[:8], pt.w_valid[:2], pt.n[:2], pt.ctx[:2]]
        specs = [dx.TileSpec(16, True, 4, 8, 2, 0, 0, 10**9)]
    elif label == "two tiles on one row0":
        specs = [a, dataclasses.replace(b, row0=0)]
    elif label == "a row in no tile":
        specs = [a, dataclasses.replace(b, row0=a.rows + 1)]
    elif label == "overlapping slots":
        specs = [a, dataclasses.replace(b, out0=a.N)]
    elif label == "overlapping tokens past the buffer":
        specs = [a, dataclasses.replace(b, tok0=a.rows * a.W - 32)]
        tens[0] = pt.tokens[: a.rows * a.W + 80]
    else:
        raise KeyError(label)
    return lambda: dx.PassTable(*tens, specs, pt.lengths, pt.offsets,
                                pt.table)


def check_x3_refusals(device) -> int:
    """Every ``X3_REFUSED`` case raises ValueError on ``device``, and X3's
    launch count stays as it was; returns the cases refused."""
    from dint_tpu_torch.kernels import decode_xla as dx

    before = dx.decode_pass.launches
    for label in X3_REFUSED:
        call = x3_refused_case(label, device)
        try:
            call()
        except ValueError:
            continue
        fail(f"X3's PassTable took a pass it must refuse: {label}")
    if dx.decode_pass.launches != before:
        fail("X3 launched while its PassTable refused bad passes")
    return len(X3_REFUSED)


def x3_args(case, device):
    """A case of ``x3_edge_tiles`` as decode_units' tensors on ``device``
    (u32 arrays as their int32 bits)."""
    import torch

    def up(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32)).to(device)

    return [up(a) for a in case[1]]


def check_x3(cases) -> int:
    """X3 equal to its plain version under torch.equal (val, produced,
    consumed) on each (label, args, b, n_out, clean) of ``cases``, args
    on the card; return the largest |kernel - plain| over the u32
    values."""
    import torch

    from dint_tpu_torch.kernels import decode_xla as dx

    worst = 0
    for label, args, b, n_out, clean in cases:
        got = dx.decode_units(*args, b=b, n_out=n_out, assume_clean=clean)
        want = dx.decode_units_plain(*args, b=b, n_out=n_out,
                                     assume_clean=clean)
        torch.cuda.synchronize()
        worst = max(worst, u32_err(got[0], want[0]))
        for g, w, what in zip(got, want, ("val", "produced", "consumed")):
            if not torch.equal(g, w):
                fail(f"X3 disagrees with its plain version on {label}: "
                     f"{what} (max abs err of val {u32_err(got[0], want[0])})")
    return worst


def check_x3_pass(labels, pt) -> int:
    """X3's one launch over the pass table ``pt`` equal to its plain version
    (``decode_units_plain`` tile by tile) under torch.equal on every tile
    (val, produced, consumed); return the largest |kernel - plain| over
    the u32 values."""
    import torch

    from dint_tpu_torch.kernels import decode_xla as dx

    got = dx.decode_pass(pt)
    torch.cuda.synchronize()
    worst = 0
    for label, g, w in zip(labels, got, dx.decode_pass_plain(pt)):
        worst = max(worst, u32_err(g[0], w[0]))
        for a, b, what in zip(g, w, ("val", "produced", "consumed")):
            if not torch.equal(a, b):
                fail(f"X3's pass disagrees with its plain version on {label}: "
                     f"{what} (max abs err of val {u32_err(g[0], w[0])})")
    return worst


def tile_labels(engine) -> list:
    """A label for each tile of a raw DecodeEngine."""
    out = []
    for i, (bi, *_rest) in enumerate(engine.tiles):
        bk = engine.buckets[bi]
        out.append(f"tile {i} ({bk.W}/{bk.N}/{bk.b}/"
                   f"{'clean' if bk.clean else 'dirty'})")
    return out


@contextlib.contextmanager
def count_plain_raw():
    """Calls of decode_units_plain on card tensors while the block runs
    (the pass's plain version looks it up in its module)."""
    from dint_tpu_torch.kernels import decode_xla as dx

    plain = dx.decode_units_plain
    calls = []

    def counted(cw, *a, **k):
        if cw.device.type != "cpu":
            calls.append(cw.shape)
        return plain(cw, *a, **k)

    dx.decode_units_plain = counted
    try:
        yield calls
    finally:
        dx.decode_units_plain = plain


@contextlib.contextmanager
def plain_x3():
    """The raw engine's passes with X3's plain version (the torch ops the
    engine ran before X3, tile by tile) in the place of the launch."""
    from dint_tpu_torch.kernels import decode_xla as dx

    kernel = dx.decode_pass
    dx.decode_pass = dx.decode_pass_plain
    try:
        yield
    finally:
        dx.decode_pass = kernel


def x3_tile_bytes(engine):
    """Per tile of a raw DecodeEngine: (bytes that do not depend on the
    dictionary, the tile's dictionary keys ctx * E + entry of its visited
    codewords).  The fixed bytes: the in-range tokens, 4 B each, 12 B of
    row metadata, and the outputs, n_out * 4 + 8 B a row.  Visited is
    the plain version's chain scan on the card, once a dirty tile."""
    import torch

    from dint_tpu_torch.config import EXCEPTIONS
    from dint_tpu_torch.kernels import decode_xla as dx

    E = engine.lengths.shape[1]
    out = []
    for bi, r0, rows, cw, wv, n, ctx in engine.tiles:
        bk = engine.buckets[bi]
        tok = bk.cw[r0 : r0 + rows].astype(np.int64)
        w_eff = np.clip(bk.w_valid[r0 : r0 + rows], 0, bk.W)
        inr = np.arange(bk.W)[None, :] < w_eff[:, None]
        if bk.clean:
            vis = inr
        else:
            safe = torch.where(torch.from_numpy(inr).to(cw.device), cw,
                               EXCEPTIONS)
            vis = dx._chain_visited(safe, bk.b).cpu().numpy() & inr
        keep = vis & (tok >= EXCEPTIONS)
        c = bk.ctx[r0 : r0 + rows].astype(np.int64)[:, None]
        keys = (c * E + np.minimum(tok, E - 1))[keep]
        fixed = 4 * int(w_eff.sum()) + 12 * rows + rows * (4 * bk.N + 8)
        out.append((fixed, np.unique(keys)))
    return out


def x3_group_bytes(tile_bytes, lengths_flat: np.ndarray, idx) -> int:
    """Bytes of the tiles ``idx``: their fixed bytes, and each dictionary
    entry they name once (its length and offset, and its first min(len,
    16) table words)."""
    fixed = sum(tile_bytes[i][0] for i in idx)
    keys = np.unique(np.concatenate([tile_bytes[i][1] for i in idx]
                                    or [np.zeros(0, np.int64)]))
    words = np.minimum(lengths_flat[keys], 16).clip(0).sum()
    return fixed + 8 * keys.shape[0] + 4 * int(words)


def tile_times(eng, fn, iters: int, flush) -> list:
    """Median ms of ``fn`` (X3's plain version) on each tile of a raw
    DecodeEngine: ``iters`` passes, each call alone between two CUDA
    events after the L2 was flushed by reading ``flush``; the plain
    version's many launches a tile outrun any queue, so its time is the
    call's as it runs."""
    import torch

    def call(i):
        bi, r0, rows, cw, wv, n, ctx = eng.tiles[i]
        bk = eng.buckets[bi]
        return fn(cw, wv, n, ctx, eng.lengths, eng.offsets, eng.table,
                  b=bk.b, n_out=bk.N, assume_clean=bk.clean)

    for i in range(len(eng.tiles)):
        call(i)
    torch.cuda.synchronize()
    times = [[] for _ in eng.tiles]
    for _ in range(iters):
        events = []
        for i in range(len(eng.tiles)):
            flush.amax()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call(i)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        for t, (a, b) in zip(times, events):
            t.append(a.elapsed_time(b))
    return [sorted(t)[len(t) // 2] for t in times]


def class_pass(eng, idx):
    """A pass table of the tiles ``idx`` of a raw DecodeEngine alone (a
    census class), on the engine's device."""
    from dint_tpu_torch.kernels import decode_xla as dx

    tiles = []
    for i in idx:
        bi, r0, rows, *_rest = eng.tiles[i]
        bk = eng.buckets[bi]
        sl = slice(r0, r0 + rows)
        tiles.append((bk.cw[sl], bk.w_valid[sl], bk.n[sl], bk.ctx[sl], bk.b,
                      bk.N, bk.clean))
    return dx.pass_table(tiles, eng.lengths, eng.offsets, eng.table)


def time_x3(dec, card_name: str) -> dict:
    """X3 on a raw StreamDecoder's tiles, census class by class (the
    class's tiles alone in a pass table) and a whole pass: one launch
    (``time_ms``: X3_ITERS calls, L2 flushed), two rounds; its plain
    version tile by tile (``tile_times``, X3_PLAIN_ITERS) summed; both
    against the bytes bound."""
    import torch

    from dint_tpu_torch.kernels import decode_xla as dx

    eng = dec.engine
    tb = x3_tile_bytes(eng)
    lengths_flat = eng.lengths.reshape(-1).cpu().numpy()
    groups = {}
    for i, (bi, *_rest) in enumerate(eng.tiles):
        bk = eng.buckets[bi]
        key = f"{bk.W}/{bk.N}/{bk.b}/{'clean' if bk.clean else 'dirty'}"
        groups.setdefault(key, []).append(i)
    groups["pass"] = list(range(len(eng.tiles)))
    flush = torch.zeros(24 << 20, dtype=torch.int32, device="cuda")
    plain = [tile_times(eng, dx.decode_units_plain, X3_PLAIN_ITERS, flush)
             for _ in range(2)]
    out = {}
    for key, idx in groups.items():
        pt = eng.pass_table if key == "pass" else class_pass(eng, idx)
        ms = sum(time_ms(lambda: dx.decode_pass(pt), X3_ITERS, flush)
                 for _ in range(2)) / 2
        del pt
        out[key] = {"tiles": len(idx),
                    "rows": sum(eng.tiles[i][2] for i in idx), "ms": ms,
                    "plain_ms": sum(sum(t[i] for i in idx) for t in plain) / 2,
                    **bound_entry(x3_group_bytes(tb, lengths_flat, idx), 0.0,
                                  card_name)}
    del flush
    return out


def x4_edge_classes(device, seed: int = 5):
    """[(label, ByteClasses)] for both group widths: every length 1-5,
    sizes no multiple of four or of a block, an empty class between
    others, bytes with the marker bit set and all ones."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    rng = np.random.default_rng(seed)
    vpb = ud.X4_VALUES_PER_BLOCK
    out = []
    for gb in (7, 8):
        classes = []
        for L, N in ((1, 5), (2, vpb + 3), (3, 0), (4, 2 * vpb), (5, 7),
                     (3, 1), (5, vpb - 1), (2, 4), (1, 3 * vpb + 2)):
            b = rng.integers(0, 256, size=(N, L)).astype(np.uint8)
            b[::3] |= 0x80
            b[1::7] = 0xFF
            classes.append((L, torch.from_numpy(b).to(device)))
        out.append((f"edge classes, group_bits {gb}",
                     ud.ByteClasses(classes, gb, device)))
    return out


def check_x4(cases) -> int:
    """X4 equal to its plain version under torch.equal on every class of
    each (label, ByteClasses) of ``cases``, for the three salts; return
    the largest |kernel - plain| over the u32 values."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    worst = 0
    for label, bc in cases:
        for s in SALTS:
            st = torch.tensor([s], dtype=torch.int64, device=bc.device)
            got = [o.clone() for o in ud.byteclass_unpack(bc, st)]
            want = bc.plain(st)
            torch.cuda.synchronize()
            for (L, _), g, p in zip(bc.classes, got, want):
                diff = u32_err(g, p) if p.numel() else 0
                worst = max(worst, diff)
                if not torch.equal(g, p):
                    fail(f"X4 disagrees with its plain version on {label}, "
                         f"L={L}, salt {s:#x} (max abs err {diff})")
    return worst


def torch_op_byte_chain(eng, runs: int):
    """ByteClassEngine.chain as it ran before X4 (and runs on the CPU):
    a shift/or over each class and the sample of its first 8 values;
    the same checksum."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    gb = eng.plan.group_bits
    pvals = ud._u32_tensor(np.concatenate(
        [v for _, v in eng.plan.partials] or [np.zeros(0, np.uint32)]),
        eng.device)
    salt = torch.ones((), dtype=torch.int64, device=eng.device)
    for _ in range(runs):
        s32 = ud._to_i32(salt)
        samples = [ud._byteclass_unpack(b, gb, s32)[:8] for _, b in eng._dev]
        samples.append(pvals + s32)
        samp = torch.cat(samples)
        total = samp.sum(dtype=torch.int32).to(torch.int64)
        salt = (total - salt * samp.numel() + salt + 1) & MASK
    return salt


def byte_chain_turns(eng, runs: int, rounds: int = 2) -> dict:
    """ms a run of the byte engine's chain through X4 and through the
    torch-op chain, in turns (X4, torch ops, X4, torch ops), CUDA events
    around each chain after one warm-up chain of each; the final
    checksums equal."""
    import torch

    chains = {"x4": eng.chain, "plain": lambda r: torch_op_byte_chain(eng, r)}

    def timed(chain):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        salt = chain(runs)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / runs, int(salt.item())

    for chain in chains.values():
        int(chain(2).item())
    ms = {k: [] for k in chains}
    salts = set()
    for _ in range(rounds):
        for k, chain in chains.items():
            t, s = timed(chain)
            ms[k].append(t)
            salts.add(s)
    if len(salts) != 1:
        fail(f"the byte chain's checksum differs between X4 and the torch-op "
             f"chain: {sorted(salts)}")
    n = eng.plan.total_ints
    out = {"runs": runs, "rounds": rounds}
    for k, v in ms.items():
        out[f"{k}_ms_per_run"] = v
        out[f"{k}_ints_x_sec"] = n / (sum(v) / len(v) / 1e3)
    return out


def x4_phase(t: str, eng, plan, card_name: str, device="cuda") -> dict:
    """A byte codec's wire engine after its decode: X4 against its plain
    version on every class (three salts), the chain's checksum on the
    card against the host's, X4 timed in turns with its plain version
    (CUDA events, L2 flushed) against the bytes bound, and the chain in
    turns with the torch-op chain."""
    import torch

    from dint_tpu_torch.kernels import unpack_device as ud

    bc = eng._x4
    err = check_x4([(f"zoo {t}", bc)]) if device != "cpu" else 0
    card = int(eng.chain(X4_CHECK_RUNS).item())
    host = int(ud.ByteClassEngine(plan, device="cpu").chain(
        X4_CHECK_RUNS).item())
    if card != host:
        fail(f"zoo {t}: X4 chain checksum {card:#x} on the card, {host:#x} "
             f"on the host")
    rec = {"max_abs_err": err, "chain_checksum": card,
           "classes": [[L, int(b.shape[0])] for L, b in bc.classes]}
    if device == "cpu":
        return rec
    flush = torch.zeros(24 << 20, dtype=torch.int32, device=device)
    salt = torch.tensor([0x9E3779B9], dtype=torch.int64, device=device)
    ms = time_in_turns({"x4": lambda: ud.byteclass_unpack(bc, salt),
                        "plain": lambda: bc.plain(salt)}, X4_ITERS, flush)
    del flush
    nbytes = sum(b.numel() for _, b in bc.classes) + 4 * sum(
        o.numel() for o in bc.outs) + 8
    rec.update({"ms": ms["x4"], "plain_ms": ms["plain"],
                **bound_entry(nbytes, 0.0, card_name),
                "turns": byte_chain_turns(eng, ZOO_TURN_RUNS)})
    return rec


def require_x3(counts, plain_calls, path: str, want: int) -> None:
    """``path`` launched X3 exactly ``want`` times (one a pass) and ran its
    plain version on no card tensor; on the CPU (a rehearsal) no
    launch."""
    import torch

    got = counts[X3]
    if got != (want if torch.cuda.is_available() else 0):
        fail(f"{got} X3 launches on the {path} path, not {want}")
    if plain_calls:
        fail(f"the {path} path ran decode_units_plain on the card "
             f"{len(plain_calls)} times")
    others = {k: v for k, v in counts.items() if v and k != X3}
    if others:
        fail(f"the {path} path launched other kernels: {others}")


def engine_build_s(engine, device) -> float:
    """Seconds of one build of a raw ``DecodeEngine`` over ``engine``'s
    dictionary view and buckets on ``device`` (uploads, readback, row
    table, checks), ending in a sync."""
    import torch

    from dint_tpu_torch.kernels import pipeline

    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.DecodeEngine(engine.view, engine.buckets, device)
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def raw_phases(data, base: str, smi: str, card_name: str, device="cuda"):
    """Phase 15: ``decode_stream(engine="raw")`` for both DINT types,
    exact over every list, launches counted from zero (X3 once a pass, no
    torch-op decode on the card); then the bucket census, the engine's
    build timed once, X3 against its plain version on every tile of a pass and
    on the edge tiles (one a launch, and all in one mixed pass), the bad
    passes of ``X3_REFUSED`` refused with no launch, X3 timed a census
    class and a pass against the bytes bound and the plain version, and
    torch.profiler traces of passes through X3 and through the torch
    ops.  Returns ({type: record}, X3's
    kernels-line entry or None on the CPU)."""
    import torch

    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import decode

    on_card = device != "cpu"
    out = {}
    edge = [(c[0], x3_args(c, device), *c[2:]) for c in x3_edge_tiles()]
    worst = 0
    if on_card:
        worst = max(check_x3(edge), check_x3_pass(*x3_edge_pass(device)))
        log(f"X3 equals its plain version on {len(edge)} edge tiles, one a "
            f"launch and as one mixed pass")
    refused = check_x3_refusals(device)
    log(f"X3's PassTable refused {refused} bad passes on {device}, no launch")
    launches = 0
    for t in TYPES:
        stream, dict_file = data[t]
        reset_launch_counts()
        with count_plain_raw() as plain_calls:
            rec = decode.decode_stream(t, stream, dict_file, runs=RAW_RUNS,
                                       check_collection=base + ".docs",
                                       engine="raw", device=device)
        counts = launch_counts()
        if rec.get("check") != "ok":
            fail(f"raw {t}: collection check did not pass")
        arena, meta = stream_mod.load_stream(stream)
        view = decode.load_dictionary(t, dict_file).decode_view()
        dec = decode.StreamDecoder(arena, meta, view, t.startswith("multi"),
                                   "raw", device=device)
        census = dec.engine.census()
        tiles = len(dec.engine.tiles)
        build_s = engine_build_s(dec.engine, device)
        require_x3(counts, plain_calls, f"raw {t}", RAW_RUNS + 2)
        launches += counts[X3]

        def runs(k):
            def go():
                for _ in range(k):
                    dec.decode_all()
            return go

        prof = profile_device(runs(RAW_PROFILE_RUNS), RAW_PROFILE_RUNS,
                              os.path.join(CACHE, f"raw_trace.{t}.json"))
        with plain_x3():
            prof_plain = profile_device(
                runs(RAW_PLAIN_PROFILE_RUNS), RAW_PLAIN_PROFILE_RUNS,
                os.path.join(CACHE, f"raw_trace_plain.{t}.json"))
        items = dec.engine.pass_table.items
        out[t] = {
            "type": t, "ints_x_sec": rec["ints_x_sec"],
            "ns_x_int": rec["ns_x_int"],
            "num_integers": rec["num_integers"], "runs": rec["runs"],
            "cold_start_s": rec["cold_start_s"], "check": rec["check"],
            "census": census, "tiles": tiles,
            "rows": dec.engine.pass_table.R,
            "blocks": {"block_rows": int((items[:, 1] == 0).sum()),
                       "warp_rows": int((items[:, 1] == 1).sum())},
            "engine_build_s": build_s, "profile": prof,
            "profile_torch_ops": prof_plain,
            "launches": {k: v for k, v in counts.items() if v},
            "device": rec["device"], "nvidia_smi": smi,
        }
        if on_card:
            worst = max(worst, check_x3_pass(tile_labels(dec.engine),
                                             dec.engine.pass_table))
            out[t]["x3"] = time_x3(dec, card_name)
            p = out[t]["x3"]["pass"]
            log(f"X3 pass of {t}: {p['ms'] * 1e3:.1f} us (bound "
                f"{p['bound_ms'] * 1e3:.1f} us, plain {p['plain_ms']:.2f} ms)")
        log(f"raw {t}: {int(rec['ints_x_sec']) / 1e9:.3f} G ints/s, "
            f"{census['units_clean']} clean / {census['units_dirty']} dirty "
            f"units, {tiles} tiles, {items.shape[0]} blocks a pass")
        del dec
        torch.cuda.empty_cache()
    if not on_card:
        return out, None
    passes = [out[t]["x3"]["pass"] for t in TYPES]
    x3 = {
        "name": X3, "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/raw_decode.cu",
        "replaces": "dint_tpu/kernels/decode_xla.py:121 (decode_units, run "
                    "a tile at a time by kernels/pipeline.py:178-190)",
        "launches": launches, "max_abs_err": worst, "refused": refused,
        "ms": sum(p["ms"] for p in passes),
        "plain_ms": sum(p["plain_ms"] for p in passes),
        **bound_entry(sum(p["bytes"] for p in passes), 0.0, card_name),
        "library_ms": None, "launches_by_path": {"raw": launches},
        "timed": "one pass over every tile of each bench stream, one "
                 "launch, summed over the two streams",
        "by_stream": {t: out[t]["x3"] for t in TYPES},
    }
    return out, x3


def zoo_data(base: str):
    """Every zoo type encoded from the collection under
    ``.chip_smoke/zoo/`` (kept when present), the lists of all the types
    in one process pool; returns ({type: stream path}, encode seconds or
    None when every stream was there)."""
    from dint_tpu_torch.tools import common, encode

    root = os.path.join(CACHE, "zoo")
    os.makedirs(root, exist_ok=True)
    paths = {t: os.path.join(root, f"zoo.{t}") for t in common.VROOM_ZOO}
    todo = {t: p for t, p in paths.items()
            if not os.path.exists(p + ".skips.npz")}
    if not todo:
        return paths, None
    t0 = time.perf_counter()
    encode.encode_zoo_many(todo, base + ".docs", workers=os.cpu_count() or 1)
    secs = time.perf_counter() - t0
    log(f"encoded {len(todo)} zoo types in one pool in {secs:.1f} s")
    return paths, secs


def require_x4(counts, path: str, want: int) -> None:
    """``path`` launched X4 exactly ``want`` times (one a chained run and
    one a whole decode); on the CPU (a rehearsal) none."""
    import torch

    got = counts[X4]
    if got != (want if torch.cuda.is_available() else 0):
        fail(f"{got} X4 launches on the {path} path, not {want}")


def zoo_phases(base: str, smi: str, card_name: str, device="cuda"):
    """Phase 16: every zoo type through ``tools.decode``'s device path on
    the card, the ladder image at ZOO_RUNS chained runs and, for the
    types with one, the wire-structure engine at ZOO_WIRE_RUNS, each
    checked against the collection list for list; for the five byte
    codecs X4 against its plain version (``x4_phase``) and on edge
    classes; then torch.profiler traces of the chains of ZOO_PROFILED
    and of the byte engine's torch-op chain.  Returns (the phase record,
    X4's kernels-line entry or None on the CPU)."""
    import torch

    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import common, decode

    t0 = time.perf_counter()
    paths, enc_s = zoo_data(base)
    data_s = time.perf_counter() - t0
    keys = ("ints_x_sec", "ns_x_int", "runs", "plan_bytes", "cold_start_s",
            "check")
    types = {}
    counts = {}
    for t in common.VROOM_ZOO:
        n_ints = None
        entry = {"stream_bytes": os.path.getsize(paths[t])}
        for wire, runs in ((False, ZOO_RUNS), (True, ZOO_WIRE_RUNS)):
            if wire and t not in decode.WIRE_ENGINES:
                continue
            reset_launch_counts()
            rec = decode.decode_zoo_device(t, paths[t], runs,
                                           base + ".docs", wire=wire,
                                           device=device)
            c = launch_counts()
            counts = add_counts(counts, c)
            if rec.get("check") != "ok":
                fail(f"zoo {t} (wire={wire}): collection check did not pass")
            # the ladder image and optpfor's folded classes: X1, one launch
            # a chained run and one for the whole decode; the other wire
            # engines keep their torch ops
            x1_path = not wire or t == "optpfor"
            require_x1(c, f"zoo {t} (wire={wire})",
                       2 * runs + 1 if x1_path else 0)
            x4_path = wire and t in BYTE_WIRE
            require_x4(c, f"zoo {t} (wire={wire})",
                       2 * runs + 1 if x4_path else 0)
            n_ints = int(rec["num_integers"])
            r = {k: rec[k] for k in keys}
            r["image_bytes_per_int"] = int(rec["plan_bytes"]) / n_ints
            r["launches"] = {k: v for k, v in c.items() if v}
            if x4_path:
                arena, meta = stream_mod.load_stream(paths[t])
                eng, plan = decode.zoo_device_engine(t, arena, meta, True,
                                                     device)
                r["x4"] = x4_phase(t, eng, plan, card_name, device)
                del eng, plan
            entry["wire" if wire else "ladder"] = r
            torch.cuda.empty_cache()
        if device != "cpu":
            arena, meta = stream_mod.load_stream(paths[t])
            eng, _ = decode.zoo_device_engine(t, arena, meta, False, device)
            entry["ladder"]["turns"] = chain_in_turns(eng, ZOO_TURN_RUNS)
            del eng
            torch.cuda.empty_cache()
        entry["num_integers"] = n_ints
        entry["stream_bpi"] = 8 * entry["stream_bytes"] / n_ints
        types[t] = entry
        log(f"zoo {t}: ladder {int(entry['ladder']['ints_x_sec']) / 1e9:.1f} "
            f"G ints/s" + (f", wire {int(entry['wire']['ints_x_sec']) / 1e9:.1f}"
                           f" G ints/s" if "wire" in entry else ""))
    profiles = {}
    for t, wire in ZOO_PROFILED:
        arena, meta = stream_mod.load_stream(paths[t])
        eng, _ = decode.zoo_device_engine(t, arena, meta, wire, device)
        key = f"{t}/{'wire' if wire else 'ladder'}"
        profiles[key] = profile_device(
            lambda: eng.chain(ZOO_PROFILE_RUNS), ZOO_PROFILE_RUNS,
            os.path.join(CACHE, f"zoo_trace.{t}.{int(wire)}.json"))
        if wire and t in BYTE_WIRE:
            profiles[key + "/torch_ops"] = profile_device(
                lambda: torch_op_byte_chain(eng, ZOO_PROFILE_RUNS),
                ZOO_PROFILE_RUNS,
                os.path.join(CACHE, f"zoo_trace.{t}.torch_ops.json"))
        del eng
        torch.cuda.empty_cache()
    rec = {"types": types, "profiles": profiles, "data_s": data_s,
           "encode_all_s": enc_s, "paths": paths,
           "launches": counts, "nvidia_smi": smi}
    if device == "cpu":
        return rec, None
    edge_err = check_x4(x4_edge_classes(device))
    by_codec = {t: types[t]["wire"]["x4"] for t in BYTE_WIRE}
    main = by_codec[BYTE_WIRE[0]]
    x4 = {
        "name": X4, "route": "cuda",
        "source": "dint_tpu_torch/kernels/csrc/byteclass_unpack.cu",
        "replaces": "dint_tpu/kernels/unpack_device.py:841 "
                    "(_byteclass_unpack, one a class in ByteClassEngine "
                    ":766, chained by its timed_chain)",
        "launches": counts[X4],
        "max_abs_err": max([edge_err] + [r["max_abs_err"]
                                         for r in by_codec.values()]),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bytes": main["bytes"], "library_ms": None,
        "launches_by_path": {"zoo": counts[X4]},
        "timed": f"{BYTE_WIRE[0]}'s wire plan (every codec in by_codec)",
        "by_codec": {t: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bytes", "classes")}
                     for t, r in by_codec.items()},
    }
    return rec, x4


# ---------------------------------------------------------------------------
# The sharded path (parallel/), the statistics merge, the dry run
# ---------------------------------------------------------------------------


def np_mix32(x: np.ndarray) -> np.ndarray:
    """numpy replay of ``steps.mix32`` in u32 arithmetic."""
    z = np.asarray(x, np.uint32)
    z = (z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    z = (z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return z ^ (z >> np.uint32(16))


def np_stats_histogram(blocks: np.ndarray, n_buckets: int) -> np.ndarray:
    """numpy replay of ``steps.stats_training_step``'s histogram: every
    target-size window of every block hashed (FNV-style over mix32),
    bucketed and counted under its block's selector."""
    from dint_tpu_torch.config import NUM_SELECTORS, TARGET_SIZES
    from dint_tpu_torch.stats import collectors

    B = blocks.shape[0]
    sel = collectors.selectors_for_blocks(blocks).astype(np.int64)
    idx = []
    for s in TARGET_SIZES:
        wins = blocks.reshape(B, 256 // s, s)
        h = np.zeros((B, 256 // s), np.uint32)
        for t in range(s):
            h = (h * np.uint32(0x01000193)) ^ np_mix32(wins[:, :, t])
        bucket = (h & np.uint32(n_buckets - 1)).astype(np.int64)
        idx.append((sel[:, None] * n_buckets + bucket).ravel())
    return np.bincount(np.concatenate(idx),
                       minlength=NUM_SELECTORS * n_buckets)


def sharded_steps_rank(rank, world, device, blocks, packed, counts, small):
    """Phase 17's rank body: every sharded step on this rank's tensors,
    each timed by CUDA events (median of STEP_ITERS, L2 flushed)."""
    import torch

    from dint_tpu_torch.parallel import dist as pdist
    from dint_tpu_torch.parallel import steps

    up = lambda a: pdist.to_tensors(a, device)
    flush = torch.zeros(24 << 20, dtype=torch.int32, device=device)
    tb = up(blocks)
    hist, sel = steps.stats_training_step(tb, n_buckets=STATS_BUCKETS)
    pk = {w: up(a[rank]) for w, a in packed.items()}
    ct = {w: int(c[rank]) for w, c in counts.items()}
    reset_launch_counts()
    louts, total = steps.ladder_sharded_decode_step(pk, ct)
    launches = launch_counts()
    cand, lists = up(small["cand"]), up(small["lists"][rank])
    valid = torch.ones(lists.shape[0], dtype=torch.bool, device=device)
    parts = up(small["parts"][rank])
    ddocs, dscores = up(small["ddocs"][rank]), up(small["dscores"][rank])
    calls = {
        "stats_training_step": lambda: steps.stats_training_step(
            tb, n_buckets=STATS_BUCKETS),
        "ladder_sharded_decode_step":
            lambda: steps.ladder_sharded_decode_step(pk, ct),
        "term_sharded_and_step":
            lambda: steps.term_sharded_and_step(cand, lists, valid),
        "term_sharded_topk_step":
            lambda: steps.term_sharded_topk_step(parts, TOPK),
        "doc_sharded_topk_step":
            lambda: steps.doc_sharded_topk_step(ddocs, dscores, TOPK),
    }
    outs = {name: fn() for name, fn in calls.items() if name.startswith(
        ("term", "doc"))}
    ms, prof = "not measured", "not measured"
    if device.type == "cuda":
        ms = {name: time_ms(fn, STEP_ITERS, flush)
              for name, fn in calls.items()}
        prof = {name: profile_device(
            calls[name], 1, os.path.join(CACHE, f"{name}_trace.json"))
            for name in ("stats_training_step", "ladder_sharded_decode_step")}
    return {"hist": hist, "sel": sel,
            "ladder": {w: v[: ct[w]] for w, v in louts.items()},
            "ladder_total": total, "small": outs, "ms": ms, "profile": prof,
            "launches": launches,
            "backend": torch.distributed.get_backend()}


def sharded_steps_phase(data, base: str, device="cuda"):
    """Phase 17: the sharded steps at full size on one NCCL rank of the
    card: stats_training_step over every full block of the collection's
    docid gaps (against a numpy replay of the same hashes), the sharded
    ladder decode of the single_rect stream's values (reassembled
    against the source and UnpackEngine), and the dry run's AND and
    top-k steps at its shapes (against numpy).  Returns the record."""
    from dint_tpu_torch.config import TARGET_SIZES
    from dint_tpu_torch.kernels import unpack_device
    from dint_tpu_torch.parallel import dist as pdist
    from dint_tpu_torch.parallel import dryrun, steps
    from dint_tpu_torch.tools import common

    t0 = time.perf_counter()
    gaps, _ = common.gap_lists_of(base + ".docs")
    blocks = np.concatenate([g[: g.shape[0] // 256 * 256].reshape(-1, 256)
                             for g in gaps if g.shape[0] >= 256])
    source = np.concatenate(gaps)
    flat = stream_values(data)
    if not np.array_equal(flat, source):
        fail("the single_rect stream's values are not the collection's gaps")
    packed, counts, order, (toff, tail) = steps.ladder_shard_pack(flat, 1)
    small = dryrun.step_inputs(1)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (res,) = pdist.run_ranks(sharded_steps_rank, 1, device,
                             (blocks, packed, counts, small), timeout_s=600)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np_stats_histogram(blocks, STATS_BUCKETS)
    if not np.array_equal(res["hist"], want):
        fail(f"stats_training_step's histogram differs from numpy's in "
             f"{int((res['hist'] != want).sum())} buckets")
    per_block = sum(256 // s for s in TARGET_SIZES)
    if int(res["hist"].sum()) != blocks.shape[0] * per_block:
        fail(f"histogram mass {int(res['hist'].sum())} != "
             f"{blocks.shape[0]} blocks x {per_block}")
    from dint_tpu_torch.stats import collectors

    if not np.array_equal(res["sel"], collectors.selectors_for_blocks(blocks)):
        fail("stats_training_step's selectors differ from numpy's")
    rebuilt = np.empty_like(flat)
    rb = rebuilt[:toff].reshape(-1, 256)
    for w, o in res["ladder"].items():
        rb[order[w][0]] = o.view(np.uint32)
    rebuilt[toff:] = tail
    if not np.array_equal(rebuilt, source):
        fail("the sharded ladder decode, reassembled, differs from the source")
    eng = unpack_device.UnpackEngine(unpack_device.ladder_plan_from_values(
        flat), device=device)
    if not np.array_equal(eng.decode_all_ordered(), rebuilt):
        fail("UnpackEngine.decode_all_ordered differs from the sharded decode")
    del eng
    if res["ladder_total"] != toff:
        fail(f"ladder count {res['ladder_total']} != {toff}")
    # the step's classes in one launch of X1's rows entry (none on the CPU)
    if res["launches"][X1_ROWS] != (device == "cuda"):
        fail(f"{res['launches'][X1_ROWS]} launches of X1's rows entry in "
             "one sharded ladder step, not one")
    out = res["small"]
    cand, lists = small["cand"], small["lists"][0]
    want_and = np.stack([np.isin(cand[q], lists[q]) for q in range(4)])
    if not np.array_equal(out["term_sharded_and_step"], want_and):
        fail("term_sharded_and_step differs from numpy")
    for name, scores in (("term_sharded_topk_step", small["parts"][0]),
                         ("doc_sharded_topk_step", small["dscores"][0])):
        v, ids = out[name]
        want_v = -np.sort(-scores, axis=1)[:, :TOPK]
        if not (np.array_equal(v, want_v) and np.array_equal(
                np.take_along_axis(scores, ids % 64, axis=1), v)):
            fail(f"{name} differs from numpy")
    # the rows entry on views of one uploaded tensor (a rank's offset
    # slice, unaligned, strided), as a caller holding every rank's pack
    # passes them; comparisons, not counted
    views = check_rows_views(rows_view_cases(flat, device)) if (
        device == "cuda") else "not measured"
    check_s = time.perf_counter() - t0
    rec = {
        "ranks": 1, "backend": res["backend"], "blocks": int(blocks.shape[0]),
        "rows_views": views,
        "n_buckets": STATS_BUCKETS, "histogram_mass": int(res["hist"].sum()),
        "ladder_ints": int(res["ladder_total"]), "stream_ints": int(toff
                                                                   + tail.size),
        "ladder_classes": {int(w): int(c[0]) for w, c in counts.items()},
        "step_ms": res["ms"], "profile": res["profile"], "prep_s": prep_s,
        "launches": res["launches"],
        "ranks_s": ranks_s,
        "check_s": check_s,
    }
    log(f"sharded steps on one {rec['backend']} rank: {rec['step_ms']}")
    return rec


def sharded_serve_rank(rank, world, device, paths, runs):
    """Phase 18's rank body: the serving log through serve_ranked_sharded
    on one index, unpruned then pruned, launches counted from zero; one
    cold call (it decodes the terms) and ``runs`` timed calls each."""
    import torch

    from dint_tpu_torch.index.dint_index import DintIndex
    from dint_tpu_torch.parallel import serve
    from dint_tpu_torch.query import boolean, ranked
    from dint_tpu_torch.query.term_decode import TermDecoder

    idx_path, wand_path, qfile = paths
    index = DintIndex.load(idx_path)
    wdata = ranked.WandData.load(wand_path)
    qs = boolean.parse_query_log(qfile)
    index.ensure_docs_end()
    dec = TermDecoder(index, device=device)
    reset_launch_counts()
    out = {}
    for pruned in (False, True):
        times = []
        for _ in range(runs + 1):
            t0 = time.perf_counter()
            v, ids = serve.serve_ranked_sharded(None, index, dec, wdata, qs,
                                                k=TOPK, pruned=pruned)
            if device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        key = "pruned" if pruned else "unpruned"
        out[key] = {
            "scores": v, "docids": ids, "cold_s": times[0],
            "us_per_query": [t * 1e6 / len(qs) for t in times[1:]]}
    counts = launch_counts()
    for key in out:
        out[key]["profile"] = "not measured"
        if device.type == "cuda":
            out[key]["profile"] = profile_device(
                lambda: serve.serve_ranked_sharded(
                    None, index, dec, wdata, qs, k=TOPK,
                    pruned=key == "pruned"),
                1, os.path.join(CACHE, f"sharded_serve_trace.{key}.json"))
    return {"serve": out, "launches": counts, "queries": len(qs)}


def sharded_serve_phase(paths, oracle, ranked_or_us: float, device="cuda"):
    """Phase 18: serve_ranked_sharded on one NCCL rank over the phase-8
    index and log, unpruned and pruned: top-10 against phase 11's oracle,
    the fused class launch in the launch counts and no stand-alone K1-K3
    launch, and µs a query beside the fused store's ranked_or."""
    from dint_tpu_torch.parallel import dist as pdist

    t0 = time.perf_counter()
    (res,) = pdist.run_ranks(sharded_serve_rank, 1, device,
                             (paths, SHARDED_SERVE_RUNS), timeout_s=900)
    wall_s = time.perf_counter() - t0
    counts = res["launches"]
    log(f"sharded serve launches: {counts}")
    require_fused(counts, "sharded serve")
    rec = {"ranks": 1, "queries": res["queries"], "k": TOPK,
           "runs": SHARDED_SERVE_RUNS, "wall_s": wall_s,
           "fused_store_ranked_or_us_per_query": ranked_or_us,
           "launches": counts}
    for key, r in res["serve"].items():
        fin = [np.isfinite(row) for row in r["scores"]]
        out_s = [row[m] for row, m in zip(r["scores"], fin)]
        out_d = [row[m] for row, m in zip(r["docids"], fin)]
        worst = check_topk(list(range(len(out_s))), oracle, out_s, out_d,
                           f"sharded serve ({key})")
        us = r["us_per_query"]
        rec[key] = {"max_rel_score_err": worst, "cold_s": r["cold_s"],
                    "us_per_query": us, "profile": r["profile"],
                    "us_per_query_mean": sum(us) / len(us)}
        log(f"sharded serve {key}: {rec[key]['us_per_query_mean']:.1f} us a "
            f"query (fused store ranked_or {ranked_or_us:.1f}), exact to "
            f"{worst:.2e}")
    return rec


@contextlib.contextmanager
def numpy_merges():
    """Inside the block every WindowCounter merge runs in numpy: the
    device merge's row gate is raised past any merge."""
    from dint_tpu_torch.stats import device_merge

    gate = device_merge.MIN_DEVICE_ROWS
    device_merge.MIN_DEVICE_ROWS = sys.maxsize
    try:
        yield
    finally:
        device_merge.MIN_DEVICE_ROWS = gate


def sorted_rows(windows: np.ndarray, counts: np.ndarray):
    """(windows, counts) in one content order, to compare as sets."""
    from dint_tpu_torch.stats import collectors

    order = np.argsort(collectors._rows_view(windows), kind="stable")
    return windows[order], counts[order]


def stats_merge_phase(base: str, device="cuda"):
    """Phase 19: collectors.collect_multi and collect_single over the
    collection's docid gaps, once with WindowCounter(device="cuda") and
    once with numpy merges: equal as sets of (window, count) for every
    key; the merges the card took (at least one), the rows they merged,
    and both wall times.  Returns the record."""
    import torch

    from dint_tpu_torch.stats import collectors, device_merge
    from dint_tpu_torch.tools import common

    gaps, total = common.gap_lists_of(base + ".docs")
    rec = {"ints": total}
    for name in STATS_COLLECTORS:
        fn = getattr(collectors, f"collect_{name}")
        device_merge.reset_merge_counts()
        t0 = time.perf_counter()
        card = fn(gaps, device=device)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        merges = device_merge.merge_counts()
        with numpy_merges():
            t0 = time.perf_counter()
            host = fn(gaps, device="cpu")
            host_s = time.perf_counter() - t0
        if sorted(card) != sorted(host):
            fail(f"collect_{name}: the card's keys differ from numpy's")
        windows = 0
        for key in host:
            a, b = sorted_rows(*card[key]), sorted_rows(*host[key])
            if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
                fail(f"collect_{name} {key}: the card's counts differ from "
                     "numpy's")
            windows += int(b[0].shape[0])
        rec[name] = {"card_s": card_s, "numpy_s": host_s,
                     "device_merges": merges["merges"],
                     "device_chunks": merges["chunks"],
                     "device_rows_merged": merges["rows"],
                     "distinct_windows": windows}
        log(f"collect_{name}: card {card_s:.1f} s ({merges['merges']} device "
            f"merges, {merges['rows']} rows), numpy {host_s:.1f} s, equal")
    if sum(rec[n]["device_merges"] for n in STATS_COLLECTORS) <= 0:
        fail("the card took no statistics merge")
    if torch.cuda.is_available():
        rec["profile_multi"] = profile_device(
            lambda: collectors.collect_multi(gaps, device=device), 1,
            os.path.join(CACHE, "stats_merge_trace.json"))
    return rec


# ---------------------------------------------------------------------------
# The EF and block index families, the native engine, LocalDecodeEngine
# ---------------------------------------------------------------------------


def mark(t_start: float, what: str) -> None:
    log(f"{what} done at {time.perf_counter() - t_start:.1f} s")


def build_family_indexes(base: str):
    """Phase 21: ``block_optpfor``, ``ef`` and ``opt`` built from the
    phase-2 collection by ``tools.create_freq_index --check`` (every
    posting re-decoded against the collection); returns ({kind: path},
    {kind: record})."""
    from dint_tpu_torch.tools import create_freq_index

    paths, recs = {}, {}
    for kind in FAMILY_KINDS:
        path = os.path.join(CACHE, f"family.{kind}.npz")
        t0 = time.perf_counter()
        idx = create_freq_index.main([kind, base, path, "--check"])
        recs[kind] = {"build_and_check_s": time.perf_counter() - t0,
                      **idx.size_stats(), "file_bytes": os.path.getsize(path)}
        log(f"built and checked {kind}: {recs[kind]}")
        paths[kind] = path
    return paths, recs


@contextlib.contextmanager
def keep_stores(kept: list):
    """Inside the block, every DeviceServingStore built (tools.queries
    builds one a ranked op) is also appended to ``kept``."""
    from dint_tpu_torch.query import device_serve as ds

    base = ds.DeviceServingStore

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    ds.DeviceServingStore = Kept
    try:
        yield kept
    finally:
        ds.DeviceServingStore = base


def run_queries_tool(kind: str, path: str, wand: str, qfile: str, ops: str,
                     engine: str, extra=()) -> dict:
    """``tools.queries`` as a user runs it; {op: record}."""
    from dint_tpu_torch.tools import queries as qtool

    recs = qtool.main([kind, ops, path, wand, "--queries", qfile, "--runs",
                       str(FAMILY_RUNS), "--engine", engine, *extra])
    return {r["type"]: r for r in recs}


def check_counts(qs, got, want, what: str) -> int:
    """Per-query result counts equal; returns their sum."""
    got = np.asarray(got, np.int64)
    bad = np.flatnonzero(got != np.asarray(want, np.int64))
    if bad.size:
        i = int(bad[0])
        fail(f"{what} query {i} {qs[i]}: {int(got[i])} results, not "
             f"{int(want[i])}")
    return int(got.sum())


def block_serve_phase(base, paths, family, oracle, bool_counts,
                      dint_ranked_us, card_name, device="cuda"):
    """Phase 22: ``tools.queries block_optpfor`` on the card, launches
    counted from zero: ranked_or, wand and maxscore through the fused
    store (K4; wand and maxscore pruned through ``ZooBlockCache``), and
    and/or.  Then, on the stores that path built: K4 against its plain
    version at their bucket shapes, pruned and unpruned; every ranked
    top-10 against the oracle, unpruned and pruned; the survival masks
    against the float64 replay; the and/or counts and the log's lists
    against the collection.  On the CPU (a rehearsal) nothing is
    launched and the launch counts are not asked."""
    import torch

    from dint_tpu_torch.query import boolean, device_batch
    from dint_tpu_torch.tools import queries as qtool

    _, wand, qfile = paths
    kept = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with keep_stores(kept):
        recs = run_queries_tool(BLOCK_SERVE, family[BLOCK_SERVE], wand, qfile,
                                FAMILY_OPS, "device", ["--device", device])
    tool_s = time.perf_counter() - t0
    counts = launch_counts()
    log(f"{BLOCK_SERVE} serve path launches: {counts}")
    want_k4 = sum(len(recs[op]["buckets"].split(",")) * (FAMILY_RUNS + 1)
                  for op in RANKED_OPS)
    if device != "cpu" and (counts["K4_block_copy"] <= 0
                            or counts["K4_block_copy"] != want_k4):
        fail(f"{BLOCK_SERVE}: K4 launched {counts['K4_block_copy']} times, "
             f"not once per bucket per pass ({want_k4})")
    if len(kept) != len(RANKED_OPS):
        fail(f"{BLOCK_SERVE}: {len(kept)} stores built, not one a ranked op")
    for op in RANKED_OPS:
        if recs[op].get("engine_variant") != "fused-store":
            fail(f"{BLOCK_SERVE} {op} did not take the fused store")
    for op in ("wand", "maxscore"):
        if not int(recs[op]["blocks_kept"]) < int(recs[op]["blocks_total"]):
            fail(f"{BLOCK_SERVE} {op} pruned nothing: {recs[op]}")
    store = kept[-1]
    index, dec = qtool.load_index(BLOCK_SERVE, family[BLOCK_SERVE], device)
    wdata = store.wdata
    qs = boolean.parse_query_log(qfile)
    terms = sorted({t for q in qs for t in q})
    docs, freqs, _ = read_collection(base)
    got = dec.decode_docids(terms)
    bad = [t for t in terms if not np.array_equal(got[t], docs[t])]
    if bad:
        fail(f"{BLOCK_SERVE}: terms {bad[:10]} decode wrong")
    buckets, _, _ = store._batch_metadata(qs, TOPK, prune=False)
    dev_buckets, _ = store.upload(buckets)
    pbuckets, _, pstats = store._batch_metadata(
        qs, TOPK, prune=True, lazy_cache=dec.lazy_cache)
    pruned_dev_buckets, _ = store.upload(pbuckets)
    k4_err = check_k4(store, [(f"P={P} G={blk.shape[0]}", blk, qw)
                              for P, _, blk, qw, _ in dev_buckets]
                      + [(f"pruned P={P} G={blk.shape[0]}", blk, qw)
                         for P, _, blk, qw, _ in pruned_dev_buckets])
    log(f"K4 equals its plain version at the {BLOCK_SERVE} store's "
        f"{len(dev_buckets)} + {len(pruned_dev_buckets)} bucket shapes")
    out_s, out_d, _ = store.ranked_topk(qs, k=TOPK, prune=False)
    worst = check_topk(qs, oracle, out_s, out_d, f"{BLOCK_SERVE} ranked_or")
    out_s, out_d, _ = store.ranked_topk(qs, k=TOPK, prune=True,
                                        lazy_cache=dec.lazy_cache)
    worst_pruned = check_topk(qs, oracle, out_s, out_d,
                              f"{BLOCK_SERVE} pruned")
    survival = check_survival({"index": index, "wdata": wdata,
                               "store": store, "queries": qs,
                               "decoder": dec})
    totals = {op: check_counts(qs, device_batch.boolean_count_batch(dec, qs,
                                                                    op),
                               bool_counts[op], f"{BLOCK_SERVE} {op}")
              for op in ("and", "or")}
    for op in ("and", "or"):
        if recs[op]["total_results"] != str(totals[op]):
            fail(f"{BLOCK_SERVE} {op}: the tool counted "
                 f"{recs[op]['total_results']}, not {totals[op]}")
    del kept
    torch.cuda.empty_cache()
    return {
        "kind": BLOCK_SERVE,
        "records": {op: {k: r[k] for k in ("avg", "q50", "q90", "q95",
                                           "batch_shape", "blocks_kept",
                                           "blocks_total", "store_bytes",
                                           "store_build_s", "buckets",
                                           "prune_rows_host_s")
                         if k in r} for op, r in recs.items()},
        "dint_ranked_or_avg_us": dint_ranked_us,
        "tool_s": tool_s, "k4_launches": counts["K4_block_copy"],
        "fused_class_launches": counts[FUSED],
        "k4_max_abs_err": k4_err, "max_rel_score_err": worst,
        "max_rel_score_err_pruned": worst_pruned,
        "blocks_kept": pstats["blocks_kept"],
        "blocks_total": pstats["blocks_total"], "survival": survival,
        "total_results": totals, "terms_checked": len(terms),
        "device": card_name,
    }


def ef_specs(idx) -> list:
    """(offset_bits, universe, n) of every docid list of the EF index."""
    specs = []
    for t in range(idx.num_lists):
        _, n, pos = idx._list_header(t)
        specs.append((pos, idx.num_docs, n))
    return specs


def decode_lists_turns(ef_path: str, rounds: int) -> dict:
    """Run in a fresh process: ``ef_device.decode_lists`` over every list
    of the EF index at ``ef_path`` on the card, end to end on the host
    clock; its first call, which allocates the pinned download buffer
    (the card and X2 readied before it by one X2 call over the same
    tables), apart from ``rounds`` warm calls.  Every call's lists equal
    the first call's."""
    import torch

    from dint_tpu_torch.codecs import ef_device
    from dint_tpu_torch.index.freq_index import FreqIndexEF

    idx = FreqIndexEF.load(ef_path)
    words, specs, params = idx.docs.words, ef_specs(idx), idx.params
    ef_device.decode_tensors(ef_device.upload(words, specs, params, "cuda"))
    torch.cuda.synchronize()
    got, want = [], None
    for _ in range(rounds + 1):
        t0 = time.perf_counter()
        lists = ef_device.decode_lists(words, specs, params, "cuda")
        got.append(time.perf_counter() - t0)
        want = lists if want is None else want
        if len(lists) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(lists, want)):
            raise RuntimeError("decode_lists differs from the first call's "
                               "lists")
        del lists
    return {"rounds": rounds, "seconds": {"decode_lists_s": got},
            "decode_lists_first_s": got[0],
            "decode_lists_warm_s": sorted(got[1:])[rounds // 2]}


def ef_phase(base, paths, family, oracle, bool_counts, card_name,
             device="cuda"):
    """Phase 23: every list of the ``ef`` index decoded on the card
    through ``EFTermDecoder(device_ef=True)`` (``codecs/ef_device.py``),
    equal to the host decode and the collection; ``decode_lists``' parts
    one by one and, in a fresh process, end to end
    (``decode_lists_turns``); the device decode timed alone by CUDA
    events, L2 flushed and warm in turns, against its bytes bound and
    the host loop; then ``tools.queries ef --device-ef`` on the card,
    launches counted from zero: no K4 and no class launch (the row path
    of ``device_batch``, unpruned), its top-10 against the oracle and
    its counts against the phase-11 counts."""
    import torch

    from dint_tpu_torch.codecs import ef_device
    from dint_tpu_torch.index.freq_index import EFTermDecoder, FreqIndexEF
    from dint_tpu_torch.kernels import cuda_ext
    from dint_tpu_torch.query import boolean, device_batch, ranked

    _, wand, qfile = paths
    idx = FreqIndexEF.load(family["ef"])
    docs, _, _ = read_collection(base)
    L = idx.num_lists
    dec = EFTermDecoder(idx, device=device, device_ef=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    got = dec.decode_docids(range(L))
    card_s = time.perf_counter() - t0
    decoder_counts = launch_counts()
    # one decode_lists call for every list: one X2 call (none on the CPU)
    if decoder_counts[X2] != (device == "cuda"):
        fail(f"{decoder_counts[X2]} X2 calls decoding the ef index's lists, "
             "not one")
    t0 = time.perf_counter()
    host = [idx.list_docids(t) for t in range(L)]
    host_s = time.perf_counter() - t0
    bad = [t for t in range(L) if not (np.array_equal(got[t], host[t])
                                       and np.array_equal(got[t], docs[t]))]
    if bad:
        fail(f"ef_device: lists {bad[:10]} differ from the host decode or "
             "the collection")
    specs = ef_specs(idx)
    # decode_lists' parts on the host clock, each ending in a sync
    split = {}
    t0 = time.perf_counter()
    ef_device.prepare(idx.docs.words, specs, idx.params)
    split["prepare_s"] = time.perf_counter() - t0
    # upload runs its own prepare, then copies the tables to the card
    t0 = time.perf_counter()
    tens = ef_device.upload(idx.docs.words, specs, idx.params, device)
    torch.cuda.synchronize()
    split["upload_s"] = time.perf_counter() - t0
    prep = tens.prep
    t0 = time.perf_counter()
    flat = ef_device.decode_tensors(tens)
    torch.cuda.synchronize()
    split["decode_s"] = time.perf_counter() - t0
    # the download (its pinned buffer already made by decode_docids above)
    # in turns with a pageable one, and the split: EF_SPLIT_ROUNDS rounds,
    # medians
    ends = np.cumsum(prep["geo"][0])
    parts = {"download_s": [], "pageable_download_s": [], "split_s": []}
    for _ in range(EF_SPLIT_ROUNDS):
        t0 = time.perf_counter()
        pageable = flat.cpu().numpy().view(np.uint32)
        parts["pageable_download_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        host_flat = ef_device.download(flat)
        parts["download_s"].append(time.perf_counter() - t0)
        if not np.array_equal(host_flat, pageable):
            fail("ef_device.download differs from a pageable download")
        t0 = time.perf_counter()
        lists = [v.astype(np.uint64) for v in np.split(host_flat, ends[:-1])]
        parts["split_s"].append(time.perf_counter() - t0)
        if not all(np.array_equal(a, b) for a, b in zip(lists, host)):
            fail("ef_device's parts, run one by one, differ from the host "
                 "decode")
        del lists, host_flat, pageable
    split.update({k: sorted(v)[len(v) // 2] for k, v in parts.items()})
    total, nwords = prep["sizes"]
    err = check_x2("the ef index's lists", tens) if device == "cuda" else 0
    nbytes = prep["words"].nbytes + 4 * total
    kernel = {"name": X2, "route": "cuda",
              "source": "dint_tpu_torch/kernels/csrc/ef_decode.cu",
              "replaces": "dint_tpu/codecs/ef_device.py:37 (_decode_fn)",
              "launches": 0, "max_abs_err": err, "ms": None,
              "plain_ms": None,
              # about twelve integer operations an output and eight a
              # high word (two passes)
              **bound_entry(nbytes, (12 * total + 8 * nwords)
                            / INT32_OPS_PER_S * 1e3, card_name),
              "library_ms": None, "lists": L,
              "blocks": int(prep["block_list"].shape[0])}
    prof = {}
    if device == "cuda":
        flush = torch.zeros(24 << 20, dtype=torch.int32, device=device)
        fns = {"x2": lambda: ef_device.decode_tensors(tens),
               "x2_warm": lambda: ef_device.decode_tensors(tens),
               "plain": lambda: ef_device.decode_tensors_plain(tens)}
        ms = time_in_turns(fns, EF_DEVICE_ITERS, flush, warm=("x2_warm",))
        del flush, fns
        kernel["ms"], kernel["plain_ms"] = ms["x2"], ms["plain"]
        kernel["warm_ms"] = ms["x2_warm"]
        for key, fn, runs in (("x2", ef_device.decode_tensors, 10),
                              ("plain", ef_device.decode_tensors_plain, 1)):
            prof[key] = profile_device(
                lambda fn=fn, runs=runs: [fn(tens) for _ in range(runs)],
                runs, os.path.join(CACHE, f"ef_device_trace.{key}.json"))
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
                "spawn")) as ex:
            split["end_to_end"] = ex.submit(
                decode_lists_turns, family["ef"], EF_E2E_ROUNDS).result()
    del tens, flat
    torch.cuda.empty_cache()
    out = {"lists": L, "ints": total, "high_words": nwords,
           "word_bytes": int(prep["words"].nbytes),
           "decoder_card_s": card_s, "host_loop_s": host_s,
           "decode_lists_split": split, "device_ms": kernel["ms"],
           "device_warm_ms": kernel.get("warm_ms"),
           "plain_ms": kernel["plain_ms"],
           "device_ints_x_sec": total / (kernel["ms"] / 1e3)
           if kernel["ms"] else None,
           "host_ints_x_sec": total / host_s,
           "bound_ms": kernel["bound_ms"],
           "bound_bytes": nbytes, "profile": prof,
           "decoder_launches": decoder_counts}
    log(f"ef_device: {out}")
    reset_launch_counts()
    t0 = time.perf_counter()
    recs = run_queries_tool("ef", family["ef"], wand, qfile, FAMILY_OPS,
                            "device", ["--device-ef", "--device", device])
    tool_s = time.perf_counter() - t0
    counts = launch_counts()
    if counts["K4_block_copy"] or counts[FUSED]:
        fail(f"ef serving launched K4 or the class kernels: {counts}")
    if device == "cuda" and counts[X2] <= 0:
        fail("tools.queries ef --device-ef never launched X2")
    for op in RANKED_OPS:
        if "engine_variant" in recs[op] or "blocks_kept" in recs[op]:
            fail(f"ef {op} took the fused store or pruned: {recs[op]}")
    qs = boolean.parse_query_log(qfile)
    wdata = ranked.WandData.load(wand)
    tops = device_batch.ranked_or_batch(idx, dec, wdata, qs, TOPK)
    worst = 0.0
    for i, q in enumerate(qs):
        want = oracle[i][0]
        if tops[i].shape != want.shape or not np.allclose(
                tops[i], want, rtol=RTOL, atol=ATOL):
            fail(f"ef ranked_or query {i} {q}: {tops[i]} != oracle {want}")
        if want.size:
            worst = max(worst, float(np.max(np.abs(tops[i] - want)
                                             / np.abs(want))))
    totals = {op: check_counts(qs, device_batch.boolean_count_batch(dec, qs,
                                                                    op),
                               bool_counts[op], f"ef {op}")
              for op in ("and", "or")}
    for op in ("and", "or"):
        if recs[op]["total_results"] != str(totals[op]):
            fail(f"ef {op}: the tool counted {recs[op]['total_results']}, "
                 f"not {totals[op]}")
    out.update({
        "records": {op: {k: r[k] for k in ("avg", "q50", "q90", "q95",
                                           "batch_shape") if k in r}
                    for op, r in recs.items()},
        "tool_s": tool_s, "launches": counts, "max_rel_score_err": worst,
        "total_results": totals,
    })
    kernel["launches_by_path"] = {"ef": decoder_counts[X2] + counts[X2]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    out["kernel"] = kernel
    torch.cuda.empty_cache()
    return out


def native_phase(paths, family, oracle, bool_counts, device="cuda"):
    """Phase 24: ``tools.queries --engine native`` (the C++ cursor engine
    on the host) over ``multi_packed_dint``, ``block_optpfor`` and
    ``ef`` (through the u32 block view): the tool's totals equal the
    phase-11 counts and the oracle's result counts; then the same engine
    per query: and/or counts equal the phase-11 counts, ranked top-10
    scores the oracle's."""
    from dint_tpu_torch.query import boolean, ranked
    from dint_tpu_torch.tools import queries as qtool

    idx_path, wand, qfile = paths
    qs = boolean.parse_query_log(qfile)
    wdata = ranked.WandData.load(wand)
    n_ranked = sum(int(o[0].shape[0]) for o in oracle)
    out = {}
    for kind in NATIVE_KINDS:
        path = idx_path if kind == SERVE_TYPE else family[kind]
        t0 = time.perf_counter()
        recs = run_queries_tool(kind, path, wand, qfile, NATIVE_OPS, "native",
                                ["--device", device])
        tool_s = time.perf_counter() - t0
        for op, want in (("and", int(np.sum(bool_counts["and"]))),
                         ("or", int(np.sum(bool_counts["or"]))),
                         ("ranked_or", n_ranked), ("wand", n_ranked),
                         ("maxscore", n_ranked)):
            if recs[op]["total_results"] != str(want):
                fail(f"native {kind} {op}: {recs[op]['total_results']} "
                     f"results, not {want}")
        index, dec = qtool.load_index(kind, path, device)
        eng = qtool.native_engine(kind, index, dec, wdata)
        for op in ("and", "or"):
            _, cnt, _ = eng.run(op, qs, runs=2, k=TOPK)
            check_counts(qs, cnt, bool_counts[op], f"native {kind} {op}")
        worst = 0.0
        for op in RANKED_OPS:
            _, cnt, scores = eng.run(op, qs, runs=2, k=TOPK)
            for i, q in enumerate(qs):
                want = oracle[i][0]
                got = scores[i][:int(cnt[i])]
                if got.shape != want.shape or not np.allclose(
                        got, want, rtol=RTOL, atol=ATOL):
                    fail(f"native {kind} {op} query {i} {q}: {got} != "
                         f"oracle {want}")
                if want.size:
                    worst = max(worst, float(np.max(np.abs(got - want)
                                                     / np.abs(want))))
        out[kind] = {
            "records": {op: {k: r[k] for k in ("avg", "q50", "q90", "q95",
                                               "total_results")}
                        for op, r in recs.items()},
            "tool_s": tool_s, "max_rel_score_err": worst,
        }
        log(f"native engine over {kind}: exact ({tool_s:.1f} s)")
        del eng, index, dec
    return out


def local_chain_phase(data, base, image_recs, smi, device="cuda"):
    """Phase 25: ``LocalDecodeEngine`` over the packed per-unit plan
    (``plan_stream(..., pack_units=True)``) of both DINT streams: launches
    counted from zero over a warm-up and a timed chain of
    ``LOCAL_CHAIN_RUNS`` runs (CUDA events) and one ``decode_all``, every
    list equal to the collection; the chain's salt after
    ``LOCAL_PLAIN_RUNS`` runs on the card equal to the plain version's on
    the host.  ints/s beside ``ImageDecodeEngine``'s from phase 4.
    Returns ({type: record}, {type: launch counts})."""
    import torch

    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.kernels import decode_local as dl
    from dint_tpu_torch.tools import common, decode

    expect, _ = common.gap_lists_of(base + ".docs")
    recs, counts = {}, {}
    for t in TYPES:
        stream, dict_file = data[t]
        arena, meta = stream_mod.load_stream(stream)
        view = decode.load_dictionary(t, dict_file).decode_view()
        lay = decode.units_from_meta(arena, meta, t.startswith("multi"))
        t0 = time.perf_counter()
        plan = dl.plan_stream(arena, lay.starts, lay.byte_lens, lay.n,
                              lay.ctx, lay.b_bits, view, pack_units=True)
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng = dl.LocalDecodeEngine(plan, device=device)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        reset_launch_counts()
        int(eng.decode_chain(LOCAL_CHAIN_RUNS).item())  # warm-up
        if device == "cpu":  # a rehearsal: the host clock
            t0 = time.perf_counter()
            salt = eng.decode_chain(LOCAL_CHAIN_RUNS)
            secs = time.perf_counter() - t0
        else:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            salt = eng.decode_chain(LOCAL_CHAIN_RUNS)
            b.record()
            b.synchronize()
            secs = a.elapsed_time(b) / 1e3
        outs = eng.decode_all()
        counts[t] = launch_counts()
        require_fused(counts[t], f"LocalDecodeEngine ({t})")
        if counts[t][FUSED] not in (0, 2 * LOCAL_CHAIN_RUNS + 1):
            fail(f"{t}: {counts[t][FUSED]} fused launches for "
                 f"{LOCAL_CHAIN_RUNS} runs, not {2 * LOCAL_CHAIN_RUNS + 1}")
        units = eng.gather_units(outs, len(lay.starts), lay.n)
        lists = [np.zeros(int(n), np.uint32) for n in meta.n]
        for uid, vals in enumerate(units):
            p = int(lay.pos_in_list[uid])
            lists[lay.list_id[uid]][p:p + vals.shape[0]] = vals
        bad = [i for i, (g, e) in enumerate(zip(lists, expect))
               if not np.array_equal(g, e)]
        if bad:
            fail(f"{t}: LocalDecodeEngine lists {bad[:10]} differ from the "
                 "collection")
        card = int(eng.decode_chain(LOCAL_PLAIN_RUNS).item())
        plain = int(dl.LocalDecodeEngine(plan, device="cpu")
                    .decode_chain(LOCAL_PLAIN_RUNS).item())
        if card != plain:
            fail(f"{t}: chain salt {card:#x} on the card, {plain:#x} from "
                 "the plain version")
        # beside the image engine of the same stream, in turns: the fused
        # launch alone (L2 flushed) and a whole chain
        img = dl.ImageDecodeEngine(dl.plan_stream_image(
            arena, lay.starts, lay.byte_lens, lay.n, lay.ctx, lay.b_bits,
            view), device=device)
        s = eng._salt(0x9E3779B9)
        flush = torch.zeros(24 << 20, dtype=torch.int32, device=device)
        turns = time_in_turns({"local_fused": lambda: eng._run(s),
                               "image_fused": lambda: img._run(s),
                               "local_chain": lambda: eng.decode_chain(
                                   LOCAL_CHAIN_RUNS),
                               "image_chain": lambda: img.decode_chain(
                                   LOCAL_CHAIN_RUNS)}, 10, flush)
        del img, flush
        total = eng.total_ints()
        recs[t] = {
            "type": t, "rows": plan.rows, "plan_bytes": plan.plan_bytes(),
            "classes": {c.mode: c.rows for c in eng._classes},
            "plan_s": plan_s, "upload_s": upload_s, "runs": LOCAL_CHAIN_RUNS,
            "ints_x_sec": total * LOCAL_CHAIN_RUNS / secs,
            "image_engine_ints_x_sec": int(image_recs[t]["ints_x_sec"]),
            "num_integers": total, "salt": int(salt.item()),
            "in_turns_ms": turns,
            "plain_salt_runs": LOCAL_PLAIN_RUNS, "check": "ok",
            "nvidia_smi": smi,
        }
        log(f"LocalDecodeEngine {t}: {recs[t]}")
        del eng, outs
        torch.cuda.empty_cache()
    return recs, counts


# ---------------------------------------------------------------------------
# The last tools: check_encoded_data, check_index, pair_wise_intersect,
# dict_perf_test, and the numpy coders of encode_batch
# ---------------------------------------------------------------------------


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def changed_collection(base: str) -> str:
    """A copy of the collection under ``CACHE`` with one docid of the
    first list that leaves room moved up by one (the list stays strictly
    increasing), the ``.freqs`` copied as they are; returns its
    basename."""
    words = np.fromfile(base + ".docs", dtype="<u4")
    pos = 1 + int(words[0])  # past the num-docs singleton
    while pos < words.shape[0]:
        n = int(words[pos])
        docs = words[pos + 1:pos + 1 + n].astype(np.int64)
        room = np.flatnonzero(np.diff(docs) >= 2)
        if room.size:
            words[pos + 1 + int(room[0])] += 1
            out = os.path.join(CACHE, "changed")
            words.tofile(out + ".docs")
            shutil.copyfile(base + ".freqs", out + ".freqs")
            return out
        pos += 1 + n
    fail("no list of the collection leaves room for a changed posting")


def check_encoded_phase(data, base: str, zoo_paths, device="cuda"):
    """Phase 26: ``tools.check_encoded_data`` through its ``main`` on both
    DINT streams on ``device`` (launches counted from zero: the fused
    class launch and no class kernel alone), on the ``TOOLS_ZOO`` zoo
    stream (host decode), and on the single_rect stream against the
    collection with one posting changed, which must end in SystemExit.
    Returns (record, summed launch counts of the DINT runs, the changed
    collection's basename)."""
    from dint_tpu_torch.tools import check_encoded_data as ced

    out, counts = {}, {}
    for t in TYPES:
        stream, dict_file = data[t]
        reset_launch_counts()
        t0 = time.perf_counter()
        rec = ced.main([t, stream, base + ".docs", "--dict", dict_file,
                        "--device", device])
        secs = time.perf_counter() - t0
        c = launch_counts()
        if rec.get("check") != "ok":
            fail(f"check_encoded_data {t}: the collection check did not pass")
        require_fused(c, f"tools (check_encoded_data {t})")
        counts = add_counts(counts, c)
        out[t] = {"s": secs, "num_integers": int(rec["num_integers"]),
                  "fused_launches": c[FUSED]}
    t0 = time.perf_counter()
    rec = ced.main([TOOLS_ZOO, zoo_paths[TOOLS_ZOO], base + ".docs"])
    if rec.get("check") != "ok":
        fail(f"check_encoded_data {TOOLS_ZOO}: the check did not pass")
    out[TOOLS_ZOO] = {"s": time.perf_counter() - t0,
                      "num_integers": int(rec["num_integers"])}
    bad = changed_collection(base)
    stream, dict_file = data[TYPES[0]]
    t0 = time.perf_counter()
    try:
        ced.main([TYPES[0], stream, bad + ".docs", "--dict", dict_file,
                  "--device", device])
    except SystemExit as e:
        out["changed_posting"] = {"type": TYPES[0], "exit": str(e),
                                  "s": time.perf_counter() - t0}
    else:
        fail("check_encoded_data passed a collection with a changed posting")
    log(f"check_encoded_data: {out}")
    return out, counts, bad


def check_index_phase(base: str, paths, family, bad: str):
    """Phase 27: ``tools.check_index`` on the serve index and on the
    ``FAMILY_KINDS`` indexes, each timed; then on the serve index
    against the collection with one posting changed, which must end in
    SystemExit."""
    from dint_tpu_torch.tools import check_index as ci

    out = {}
    kinds = [(SERVE_TYPE, paths[0])] + [(k, family[k]) for k in FAMILY_KINDS]
    for kind, path in kinds:
        t0 = time.perf_counter()
        ci.main([kind, path, base])
        out[kind] = {"s": time.perf_counter() - t0}
    try:
        ci.main([SERVE_TYPE, paths[0], bad])
    except SystemExit as e:
        out["changed_posting"] = {"type": SERVE_TYPE, "exit": str(e)}
    else:
        fail("check_index passed a collection with a changed posting")
    log(f"check_index: {out}")
    return out


def pair_oracle(docs, qfile: str):
    """(two-term queries of the log, the sum of their intersection
    sizes from numpy over the collection's lists)."""
    from dint_tpu_torch.query import boolean

    pairs = [q for q in boolean.parse_query_log(qfile)
             if len(set(q)) == 2 and all(0 <= t < len(docs) for t in q)]
    total = sum(np.intersect1d(docs[a], docs[b], assume_unique=True).shape[0]
                for a, b in pairs)
    return pairs, int(total)


def pair_phase(docs, paths, family, device="cuda"):
    """Phase 28: ``tools.pair_wise_intersect`` over the serve log's
    two-term queries: the ``native`` engine and the ``python`` engine on
    ``device`` over the serve index (launches counted from zero: the
    fused class launch decodes the docids), then the ``python`` engine
    over ``PAIR_KINDS`` (host decode, no launch); every ``pairs`` and
    ``total_results`` equal to the numpy oracle's.  Returns (record,
    launch counts of the DINT python run)."""
    from dint_tpu_torch.tools import pair_wise_intersect as pwi

    idx_path, _, qfile = paths
    pairs, want = pair_oracle(docs, qfile)
    recs, counts = {}, {}
    t0 = time.perf_counter()
    recs["native"] = pwi.main([SERVE_TYPE, idx_path, "--queries", qfile,
                               "--engine", "native", "--runs",
                               str(PAIR_NATIVE_RUNS)])
    secs = {"native": time.perf_counter() - t0}
    for kind in (SERVE_TYPE,) + PAIR_KINDS:
        path = idx_path if kind == SERVE_TYPE else family[kind]
        reset_launch_counts()
        t0 = time.perf_counter()
        recs[f"python/{kind}"] = pwi.main([kind, path, "--queries", qfile,
                                           "--engine", "python", "--runs",
                                           str(PAIR_PYTHON_RUNS), "--device",
                                           device])
        secs[f"python/{kind}"] = time.perf_counter() - t0
        c = launch_counts()
        if kind == SERVE_TYPE:
            require_fused(c, "tools (pair_wise_intersect)")
            counts = c
        elif sum(c.values()):
            fail(f"pair_wise_intersect {kind} launched a kernel: {c}")
    for name, r in recs.items():
        if r["pairs"] != str(len(pairs)) or r["total_results"] != str(want):
            fail(f"pair_wise_intersect {name}: {r['pairs']} pairs, "
                 f"{r['total_results']} results; the oracle {len(pairs)}, "
                 f"{want}")
    out = {"pairs": len(pairs), "total_results": want, "seconds": secs,
           "records": {k: {f: r[f] for f in ("avg_us", "q50_us")}
                       for k, r in recs.items()},
           "fused_launches": counts.get(FUSED, 0)}
    log(f"pair_wise_intersect: {out}")
    return out, counts


def first_lists(gap_lists, limit: int):
    """The collection's lists in order, each that still fits, until
    ``limit`` ints."""
    out, n = [], 0
    for g in gap_lists:
        if n + g.shape[0] <= limit:
            out.append(g)
            n += g.shape[0]
    return out, n


def dict_coder_phase(data, base: str):
    """Phase 29: ``tools.dict_perf_test`` on both bench dictionaries,
    ``native`` at the reference's copies and runs and ``numpy``, its
    checksum equal to a numpy replay over the same draw; then the numpy
    coders of ``codecs/encode_batch`` (``prefer_native=False``) on the
    collection's first lists, bytes equal to the native encoder's on the
    same lists, both timed."""
    from dint_tpu_torch.codecs import encode_batch
    from dint_tpu_torch.config import NUM_ENTRIES
    from dint_tpu_torch.tools import common, decode
    from dint_tpu_torch.tools import dict_perf_test as dpt

    out = {}
    for t, kind in (("single_rect_dint", "rectangular"),
                    ("multi_packed_dint", "multi")):
        dict_file = data[t][1]
        t0 = time.perf_counter()
        native = dpt.main([dict_file, kind, "--copies", str(DICT_COPIES),
                           "--runs", str(DICT_RUNS)])
        t1 = time.perf_counter()
        numpy_rec = dpt.main([dict_file, kind, "--copies", str(DICT_COPIES),
                              "--engine", "numpy"])
        t2 = time.perf_counter()
        d = dpt.load(dict_file, kind)
        view = d.decode_view()
        gidx = dpt.sample_indices(d, view, kind, DICT_COPIES,
                                  np.random.default_rng(13))
        offs = view.offsets[gidx // NUM_ENTRIES, gidx % NUM_ENTRIES]
        replay = int(view.table[offs.astype(np.int64)].astype(np.int64).sum())
        if numpy_rec["checksum"] != str(replay):
            fail(f"dict_perf_test {kind}: checksum {numpy_rec['checksum']}, "
                 f"the replay's {replay}")
        out[kind] = {"native_ns_per_copy": float(native["ns_per_copy"]),
                     "numpy_ns_per_copy": float(numpy_rec["ns_per_copy"]),
                     "checksum": replay, "copies": DICT_COPIES,
                     "runs": DICT_RUNS, "native_s": t1 - t0,
                     "numpy_s": t2 - t1}
    gap_lists, _ = common.gap_lists_of(base + ".docs")
    coders = {}
    for name, t, fn, limit in (
            ("single", "single_rect_dint", encode_batch.encode_single_lists,
             CODER_SINGLE_INTS),
            ("multi", "multi_packed_dint", encode_batch.encode_multi_lists,
             CODER_MULTI_INTS)):
        d = decode.load_dictionary(t, data[t][1])
        lists, n = first_lists(gap_lists, limit)
        t0 = time.perf_counter()
        got = fn(d, lists, prefer_native=False)
        t1 = time.perf_counter()
        want = fn(d, lists, prefer_native=True)
        t2 = time.perf_counter()
        if got != want:
            bad = next(i for i, (a, b) in enumerate(zip(got[0], want[0]))
                       if a != b) if got[0] != want[0] else None
            fail(f"numpy coders ({name}) differ from the native encoder "
                 f"(first differing list {bad})")
        coders[name] = {"dictionary": t, "lists": len(lists), "ints": n,
                        "bytes": sum(len(s) for s in got[0]),
                        "numpy_s": t1 - t0, "native_s": t2 - t1,
                        "numpy_ints_x_sec": n / (t1 - t0),
                        "native_ints_x_sec": n / (t2 - t1)}
    out["coders"] = coders
    log(f"dict_perf_test and the numpy coders: {out}")
    return out


def scale_phase(device="cuda"):
    """Phase 30: ``tools.scale_test`` through its ``main`` at --ints
    SCALE_INTS (a fresh cache under ``.chip_smoke/scale``): the build
    stages, ``--decode`` and ``--serve``; launch counts set to 0 just
    before and read just after.  Both decode legs must pass their full
    collection checks and the device top-10 the host oracle's, and the
    path must have launched the fused class launch, X1 and K4.  Returns
    (the record, the counts)."""
    import torch

    from dint_tpu_torch.tools import scale_test

    cache = os.path.join(CACHE, "scale")
    shutil.rmtree(cache, ignore_errors=True)
    reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        rec = scale_test.main(["--ints", str(SCALE_INTS), "--cache-dir",
                               cache, "--decode", "--serve", "--device",
                               device])
    counts = launch_counts()
    for check in ("gather_collection", "ladder_collection",
                  "serve_device_topk_20"):
        if rec["checks"].get(check) != "ok":
            fail(f"scale_test: check {check} is {rec['checks'].get(check)}")
    for leg in ("gather", "ladder"):
        if rec["decode"][leg]["check"] != "ok":
            fail(f"scale_test: the {leg} leg's collection check did not pass")
    if torch.cuda.is_available():
        require_fused(counts, "scale")
        for key in (X1, "K4_block_copy"):
            if counts[key] <= 0:
                fail(f"{key} was never launched on the scale path")
    shutil.rmtree(cache, ignore_errors=True)
    log(f"scale_test at {SCALE_INTS:g} ints: {rec['postings']} postings, "
        f"gather {rec['decode']['gather']['ints_x_sec']:.4g} and ladder "
        f"{rec['decode']['ladder']['ints_x_sec']:.4g} ints/s, device wand "
        f"{rec['serve']['device_wand_us']['avg']:.1f} us a query; launches "
        f"fused {counts[FUSED]}, X1 {counts[X1]}, K4 {counts['K4_block_copy']}")
    return rec, counts


def entry_phase(device="cuda"):
    """Phase 31: ``dint_tpu_torch.entry.entry()``'s ``fn`` on ``device``,
    launch counts set to 0 just before and read just after (one fused
    class launch), held under torch.equal to its plain version
    (``decode_classes_plain`` on CPU copies of the same arguments) and,
    on every valid lane, to ``entry("cpu")``'s output (the reference's
    portable branch) through the engine's row map.  Returns (the
    record, the counts)."""
    import torch

    from dint_tpu_torch import entry
    from dint_tpu_torch.kernels import decode_local as dl

    fn, args = entry.entry(device)
    reset_launch_counts()
    out = fn(*args)
    if out.device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    cpu = lambda x: (None if x is None else x.to("cpu")
                     if isinstance(x, dl.TrimmedClass)
                     else tuple(t.cpu() for t in x)
                     if isinstance(x, tuple) else x.cpu())
    if out.device.type == "cuda":
        if counts[FUSED] != 1:
            fail(f"entry's fn made {counts[FUSED]} fused launches, not 1")
        want = dl.decode_classes_plain(*(cpu(a) for a in args[:3]),
                                       args[3].cpu(), exact=True)
        err = u32_err(out.cpu(), want) if want.numel() else 0
        if not torch.equal(out.cpu(), want):
            fail(f"entry's fn disagrees with its plain version (max abs "
                 f"err {err})")
        eng = dl.LocalDecodeEngine(entry.example_plan("cpu"), device="cpu")
        rows = out.cpu()[torch.from_numpy(eng._eng_of_plan)]
    else:
        err, rows = 0, out
    pfn, pargs = entry.entry("cpu")
    portable = pfn(*pargs)
    valid = (torch.arange(portable.shape[1])[None, :]
             < pargs[2][:, None].to(torch.int64))
    if not torch.equal(rows[valid], portable[valid]):
        fail("entry's fn differs from entry('cpu') on valid lanes")
    rec = {"rows": int(out.shape[0]), "plan_rows": int(portable.shape[0]),
           "ints": int(valid.sum()), "max_abs_err": err,
           "launches": counts[FUSED]}
    log(f"entry: {rec}")
    return rec, counts


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

    mark(t_start, "phase 1")

    # 2. data
    base, data = make_data(CACHE, args.seed, NUM_LISTS, NUM_DOCS, AVG_LEN)

    mark(t_start, "phase 2")

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
    errs["K3_zero"] = max(errs["K3_zero"], check_k3_widths())
    errs[FUSED] = check_fused([("bench image", fused_args(dec.engine)),
                               ("bench image, padded",
                                fused_padded_args(dec.engine))]
                              + fused_edge_cases("cuda"))
    log(f"kernels equal their plain versions on the card: {errs}; the "
        f"fused launch refused {check_fused_refusals('cuda')} classes at "
        f"odds")
    kernels = time_kernels(dec.engine, errs, kind)
    salt = chain_against_twins(dec.engine)
    log(f"chain salt on the card equals the host twins': {salt:#x}")
    prof = profile_device(lambda: dec.engine.decode_chain(PROFILE_RUNS),
                          PROFILE_RUNS, os.path.join(CACHE, "chain_trace.json"))
    print(json.dumps({"profile": prof}), flush=True)
    del dec
    # X1 against its plain version in both layouts (the bench ladder
    # image, the sharded pack of the same stream, every width on edge
    # inputs), X2 on the EF edge arena; X1 timed at the main path's
    # shapes (X2 is timed in phase 23, on the ef index)
    lad = ladder_decoder(*data["single_rect_dint"], "single_rect_dint")
    packed = shard_pack_on_card(stream_values(data))
    x_errs = check_x1(
        [("the bench ladder image", lad.engine._x1),
         ("the edge classes", x1_edge_classes("cuda"))],
        [("the bench stream's sharded pack", packed),
         ("the edge rows", x1_edge_rows("cuda"))])
    x_errs[X2] = check_x2_edges()
    log(f"X1 and X2 equal their plain versions on the card: {x_errs}; "
        f"X2's entries refused {check_x2_refusals('cuda')} bad inputs")
    x1_kernels = time_x1(lad.engine._x1, packed, x_errs, kind)
    del lad, packed
    torch.cuda.empty_cache()

    mark(t_start, "phase 3")

    # 4. the decode path, launches counted from zero
    drop_plan_caches(CACHE)
    recs, counts = drive_main_path(data, base, RUNS, "cuda")
    for t, r in recs.items():
        print(json.dumps({
            "type": t, "ints_x_sec": r["ints_x_sec"],
            "ns_x_int": r["ns_x_int"], "num_integers": r["num_integers"],
            "plan_bytes": r["plan_bytes"], "cold_start_s": r["cold_start_s"],
            "runs": r["runs"], "check": r["check"],
            "launches": counts[t], "device": kind, "nvidia_smi": smi,
        }), flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phase 4")

    # 5. the bench path (gather and ladder legs, the store probe),
    # launches counted from zero; the ladder's device-busy time
    bench_rec, bench_legs, bench_counts = drive_bench_path(args.seed)
    print(json.dumps({"bench": {**bench_rec, "launches": bench_counts,
                                "nvidia_smi": smi}}), flush=True)
    ladder_prof = profile_ladder(data, kind,
                                 os.path.join(CACHE, "ladder_trace.json"))
    print(json.dumps({"ladder_profile": ladder_prof}), flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phase 5")

    # 6. K5 against its plain version, and its times
    k5 = check_k5(total, kind)
    k5["launches"] = bench_counts["K5_store_tile"]
    k5["launches_by_path"] = {"bench": k5["launches"]}

    mark(t_start, "phase 6")

    # 7. the ablation path, launches counted from zero; K6 and K7
    # against their plain version and the flat gather, and their times
    ablate, ablate_counts, onehot = ablate_phases(*data["single_rect_dint"],
                                                  kind)
    print(json.dumps({"ablation": {**ablate, "launches": ablate_counts,
                                   "nvidia_smi": smi}}), flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phase 7")

    # 8-14. serving: data, the serve path (launches counted from zero),
    # K4 against its plain version, exactness, survival pass, host
    # engine, profiler
    paths, data_s = make_serve_data(CACHE, base)
    serve = serve_phases(base, paths, kind,
                         os.path.join(CACHE, "serve_trace.json"))
    serve["data_s"] = data_s
    oracle = serve.pop("oracle")
    bool_counts = serve.pop("bool_counts")
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
    print(json.dumps({"serve_pruned": {**serve["pruned"], "k": TOPK,
                                       "device": kind, "nvidia_smi": smi}}),
          flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phases 8-14")

    # 15. the raw chain-scan engine, both DINT types, exact, through X3
    raw, x3 = raw_phases(data, base, smi, kind)
    print(json.dumps({"raw": raw}), flush=True)

    mark(t_start, "phase 15")

    # 16. the zoo: eleven list types through the ladder image, eight
    # through their wire engines (the five byte codecs' through X4), exact
    zoo, x4 = zoo_phases(base, smi, kind)
    print(json.dumps({"zoo": {**zoo, "device": kind}}), flush=True)

    mark(t_start, "phase 16")

    # 17. the sharded steps at full size on one NCCL rank
    sharded_steps = sharded_steps_phase(data, base)
    print(json.dumps({"sharded_steps": {**sharded_steps, "device": kind,
                                        "nvidia_smi": smi}}), flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phase 17")

    # 18. serve_ranked_sharded on one NCCL rank, launches counted from 0
    sharded_serve = sharded_serve_phase(paths, oracle, ranked["avg"])
    print(json.dumps({"sharded_serve": {**sharded_serve, "device": kind,
                                        "nvidia_smi": smi}}), flush=True)

    mark(t_start, "phase 18")

    # 19. the statistics merge on the card against numpy's
    stats_merge = stats_merge_phase(base)
    print(json.dumps({"stats_merge": {**stats_merge, "device": kind,
                                      "nvidia_smi": smi}}), flush=True)
    torch.cuda.empty_cache()

    mark(t_start, "phase 19")

    # 20. the multi-rank dry run on gloo ranks of the host's CPU (the
    # host has one card, and NCCL runs one rank a card)
    from dint_tpu_torch.parallel import dryrun

    dry = dryrun.dryrun_multichip(DRYRUN_RANKS, device="cpu")
    print(json.dumps({"dryrun": dry}), flush=True)
    mark(t_start, "phase 20")

    # 21. the EF and block index families built at full size, --check
    family, family_builds = build_family_indexes(base)
    print(json.dumps({"family_builds": family_builds}), flush=True)
    mark(t_start, "phase 21")

    # 22. block_optpfor served through K4 (pruned for wand/maxscore),
    # launches counted from zero, exact
    block = block_serve_phase(base, paths, family, oracle, bool_counts,
                              ranked["avg"], kind)
    print(json.dumps({"block_serve": {**block, "nvidia_smi": smi}}),
          flush=True)
    mark(t_start, "phase 22")

    # 23. ef: every list through ef_device on the card, then the row
    # path of the queries tool (no K4), exact
    ef_rec = ef_phase(base, paths, family, oracle, bool_counts, kind)
    print(json.dumps({"ef": {**ef_rec, "device": kind, "nvidia_smi": smi}}),
          flush=True)
    mark(t_start, "phase 23")

    # 24. the native cursor engine on the host, three index kinds, exact
    native = native_phase(paths, family, oracle, bool_counts)
    print(json.dumps({"native": native}), flush=True)
    mark(t_start, "phase 24")

    # 25. LocalDecodeEngine.decode_chain over packed per-unit plans
    local, local_counts = local_chain_phase(data, base, recs, smi)
    print(json.dumps({"local_chain": {**local, "launches": local_counts,
                                      "device": kind}}), flush=True)
    mark(t_start, "phase 25")

    # 26. check_encoded_data on both DINT streams on the card (launches
    # counted from zero), a zoo stream, and a changed collection
    check_enc, tools_counts, bad = check_encoded_phase(data, base,
                                                       zoo["paths"])
    print(json.dumps({"check_encoded_data": check_enc}), flush=True)
    mark(t_start, "phase 26")

    # 27. check_index on the serve index and the three family indexes
    check_idx = check_index_phase(base, paths, family, bad)
    print(json.dumps({"check_index": check_idx}), flush=True)
    mark(t_start, "phase 27")

    # 28. pair_wise_intersect: native, and python on the card (launches
    # counted from zero), over the serve log's two-term queries
    pair, pair_counts = pair_phase(read_collection(base)[0], paths, family)
    tools_counts = add_counts(tools_counts, pair_counts)
    print(json.dumps({"pair_wise_intersect": {**pair, "device": kind,
                                              "nvidia_smi": smi}}),
          flush=True)
    mark(t_start, "phase 28")

    # 29. dict_perf_test on both bench dictionaries, the numpy coders
    dict_coders = dict_coder_phase(data, base)
    print(json.dumps({"dict_perf_test": {**dict_coders, "nvidia_smi": smi}}),
          flush=True)
    for f in (bad + ".docs", bad + ".freqs"):
        os.remove(f)
    mark(t_start, "phase 29")
    if tools_counts[FUSED] <= 0:
        fail("the tools path never launched the fused class launch")

    # 30. tools.scale_test on the card: build stages, --decode, --serve,
    # launches counted from zero
    scale, scale_counts = scale_phase()
    print(json.dumps({"scale_test": {
        key: scale[key] for key in ("postings", "decode", "serve", "checks",
                                    "stages", "card_peak_bytes", "wall_s")}
        | {"launches": {key: scale_counts[key]
                        for key in (FUSED, X1, "K4_block_copy")},
           "nvidia_smi": smi}}), flush=True)
    mark(t_start, "phase 30")

    # 31. entry()'s fn on the card against its plain version
    entry_rec, entry_counts = entry_phase()
    print(json.dumps({"entry": {**entry_rec, "device": kind}}), flush=True)
    mark(t_start, "phase 31")

    # 32. the fused launch on the benchmark cell's image, trimmed against
    # padded
    cell = cell_phase(args.seed, kind)
    print(json.dumps({"cell_image": {**cell, "nvidia_smi": smi}}),
          flush=True)
    mark(t_start, "phase 32")

    def by_path(key):
        return {"decode": sum(c[key] for t, c in counts.items()
                              if t in TYPES),
                "bench": bench_counts[key], "ablate": ablate_counts[key],
                "serve": serve["launches"][key],
                "sharded_serve": sharded_serve["launches"][key],
                "local_chain": sum(c[key] for c in local_counts.values()),
                "tools": tools_counts[key], "scale": scale_counts[key],
                "entry": entry_counts[key]}

    for k in kernels:
        # a class kernel's launches: those of its own (the ablation's K1)
        # and the fused launches whose grid ran its body
        k["launches_by_path"] = by_path(k["name"])
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] == FUSED:
            k["walked_by_path"] = by_path(WALKED)
            k["trimmed_by_path"] = by_path(TRIMMED)
            k["cell_image"] = cell
        else:
            k["standalone_launches"] = k["launches"]
            k["launches_in_fused_by_path"] = by_path(k["name"] + IN_FUSED)
            k["launches"] += sum(k["launches_in_fused_by_path"].values())
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on a main path")
        k["max_abs_err"] = max(k["max_abs_err"],
                               serve["class_errs"][k["name"]])
    k4 = serve.pop("k4")
    k4["launches_by_path"] = {"serve": k4["launches"],
                              "block_serve": block["k4_launches"],
                              "scale": scale_counts["K4_block_copy"]}
    k4["launches"] = sum(k4["launches_by_path"].values())
    k4["max_abs_err"] = max(k4["max_abs_err"], block["k4_max_abs_err"])
    x1_kernels[0]["launches_by_path"] = {
        "decode": sum(counts[f"{t}/ladder"][X1] for t in TYPES),
        "bench": bench_counts[X1], "zoo": zoo["launches"][X1],
        "scale": scale_counts[X1]}
    x1_kernels[1]["launches_by_path"] = {
        "sharded": sharded_steps["launches"][X1_ROWS]}
    x1_kernels[1]["max_abs_err"] = max(
        x1_kernels[1]["max_abs_err"],
        sharded_steps["rows_views"]["max_abs_err"])
    x2 = ef_rec.pop("kernel")
    x2["max_abs_err"] = max(x2["max_abs_err"], x_errs[X2])
    for k in x1_kernels:
        k["launches"] = sum(k["launches_by_path"].values())
    for k in (*x1_kernels, x2, x3, x4):
        if k["launches"] <= 0:
            fail(f"{k['name']} was never launched on a main path")
    kernels += [k4, k5, *onehot, *x1_kernels, x2, x3, x4]
    summary = {"card": kind, "nvidia_smi": smi, "build_s": build_s,
               "kernels": kernels, "records": recs, "launches": counts,
               "chain_salt": salt, "profile": prof, "bench": bench_rec,
               "bench_legs": bench_legs, "bench_launches": bench_counts,
               "ladder_profile": ladder_prof, "ablation": ablate,
               "ablation_launches": ablate_counts, "serve": serve,
               "raw": raw, "zoo": zoo, "sharded_steps": sharded_steps,
               "sharded_serve": sharded_serve, "stats_merge": stats_merge,
               "dryrun": dry, "family_builds": family_builds,
               "block_serve": block, "ef": ef_rec, "native": native,
               "local_chain": local, "local_chain_launches": local_counts,
               "check_encoded_data": check_enc, "check_index": check_idx,
               "pair_wise_intersect": pair, "dict_perf_test": dict_coders,
               "tools_launches": tools_counts, "scale_test": scale,
               "scale_launches": scale_counts, "entry": entry_rec,
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
