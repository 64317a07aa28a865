"""Sharded (multi-process) index construction.

The port of ``dint_tpu/parallel/build.py``, host numpy, whole.  The
reference parallelizes construction with `semiasync_queue`
(semiasync_queue.hpp:12-95, used by dict_freq_index.hpp:46-51): workers
run `prepare()` (encode a posting list) concurrently while the main
thread runs `commit()` strictly in list order, so the built index is
bit-identical to a serial build regardless of scheduling.

This module is the multi-worker analogue at coarser grain: the list
space is partitioned into contiguous ranges, each worker PROCESS builds
its range into an index part (`prepare`), and the parent concatenates
the parts in range order (`commit`).  Dictionaries are trained once on
the full collection (create-or-load cache) before workers launch,
exactly like the reference's single `build_model` preceding its
parallel encode.  The result is held by the tests to `build_index`'s
serial output, field for field.

The doc- and term-range builds make one self-contained index a shard,
the layouts that ``serve.py`` serves over a ``torch.distributed`` group
(one shard a rank).  Worker pools use the *spawn* context: a worker
starts from a fresh import, never from a fork of a process holding
torch's threads.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

from ..index import dint_index
from ..io.collection import open_freq_collection
from ..tools import common as tools_common

_PART_KEYS = ("list_n", "block_ptr", "block_max", "docs_end", "block_end", "arena")


def _build_part(args) -> str:
    """Worker: build lists [a, b) and persist the part (prepare())."""
    basename, kind, policy, cache_dir, a, b, part_path = args
    idx = dint_index.build_index(
        basename, kind=kind, policy=policy, cache_dir=cache_dir,
        list_range=(a, b),
    )
    np.savez(
        part_path,
        list_n=idx.list_n,
        block_ptr=idx.block_ptr,
        block_max=idx.block_max,
        docs_end=idx.docs_end,
        block_end=idx.block_end,
        arena=idx.arena,
    )
    return part_path


def concat_index_parts(
    kind: str,
    policy: Optional[str],
    num_docs: int,
    parts: List[dict],
    docs_dict=None,
    freqs_dict=None,
) -> dint_index.DintIndex:
    """Ordered commit: concatenate per-range parts into one index.

    Every per-list / per-block table is a plain concatenation with the
    running block-count / arena-byte offsets folded into the pointer
    arrays — the SoA layout makes the reference's in-order buffer
    append (dict_freq_index.hpp:119-122) a pure array op.
    """
    list_n = np.concatenate([p["list_n"] for p in parts])
    block_off = 0
    arena_off = 0
    bptr, bmax, dend, bend, arenas = [], [], [], [], []
    for i, p in enumerate(parts):
        ptr = np.asarray(p["block_ptr"], np.uint64) + np.uint64(block_off)
        bptr.append(ptr if i == 0 else ptr[1:])  # drop duplicated boundary
        bmax.append(p["block_max"])
        dend.append(np.asarray(p["docs_end"], np.uint64) + np.uint64(arena_off))
        bend.append(np.asarray(p["block_end"], np.uint64) + np.uint64(arena_off))
        arenas.append(p["arena"])
        block_off += int(p["block_max"].shape[0])
        arena_off += int(p["arena"].shape[0])
    return dint_index.DintIndex(
        kind,
        policy,
        num_docs,
        list_n.astype(np.uint32),
        np.concatenate(bptr),
        np.concatenate(bmax),
        np.concatenate(dend),
        np.concatenate(bend),
        np.concatenate(arenas) if arenas else np.zeros(0, np.uint8),
        docs_dict,
        freqs_dict,
    )


def partition_collection_by_doc(
    basename: str, out_dir: str, n_shards: int
) -> dict:
    """Split a collection into doc-range shard collections.

    Shard j owns docids [j*span, (j+1)*span); every posting list is
    sliced to the range (sorted docids → two searchsorteds) and rebased
    to shard-local ids.  All term ids are kept in every shard (lists a
    shard holds no postings of are written empty), so a term's id is
    global.  Returns the catalog: doc ranges, global num_docs, and the
    GLOBAL per-term document frequencies — BM25's idf must use global
    statistics no matter which shard scores a posting.
    """
    from ..io.collection import write_freq_collection

    view = open_freq_collection(basename)
    N = view.num_docs
    S = n_shards
    span = -(-max(N, 1) // S)
    lo = np.minimum(np.arange(S, dtype=np.int64) * span, N)
    hi = np.minimum(lo + span, N)
    os.makedirs(out_dir, exist_ok=True)
    # pass 0: per-list shard cut points (one searchsorted over all S+1
    # edges per list) + global df — the shard-outer passes below then
    # slice directly, so peak memory stays one shard's postings while
    # the searchsorted work runs once, not S times
    edges = np.concatenate([lo, [N]])
    cuts: List[np.ndarray] = []
    df: List[int] = []
    for d, _ in view:
        df.append(d.shape[0])
        cuts.append(np.searchsorted(d, edges).astype(np.int64))
    for j in range(S):
        docs_j: List[np.ndarray] = []
        freqs_j: List[np.ndarray] = []
        for i, (d, f) in enumerate(view):
            a, b = int(cuts[i][j]), int(cuts[i][j + 1])
            docs_j.append(
                (d[a:b].astype(np.int64) - lo[j]).astype(np.uint32)
            )
            freqs_j.append(f[a:b])
        write_freq_collection(
            os.path.join(out_dir, f"shard{j}"),
            docs_j,
            freqs_j,
            num_docs=int(hi[j] - lo[j]),
        )
    # NOTE: the catalog is NOT written here — build_doc_sharded writes
    # it after the last shard index exists, so its presence is a valid
    # completion sentinel for resumable pipelines
    return {
        "n_shards": S,
        "num_docs": N,
        "doc_lo": lo,
        "doc_hi": hi,
        "df": np.asarray(df, np.int64),
    }


def _build_shard_index(args) -> str:
    """Worker: build and save the index of one shard collection."""
    sbase, kind, policy = args
    idx = dint_index.build_index(
        sbase, kind=kind, policy=policy, cache_dir=os.path.dirname(sbase)
    )
    idx.save(sbase + ".idx")
    return sbase


def _build_shard_indexes(out_dir, prefix, n_shards, kind, policy,
                         n_workers) -> None:
    """Build every shard collection ``<prefix><j>`` of ``out_dir`` into
    its index, in a spawn pool of ``n_workers`` where that is > 1."""
    jobs = [(os.path.join(out_dir, f"{prefix}{j}"), kind, policy)
            for j in range(n_shards)]
    if n_workers > 1:
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes=min(n_workers, n_shards)) as pool:
            pool.map(_build_shard_index, jobs)
    else:
        for job in jobs:
            _build_shard_index(job)


def build_doc_sharded(
    basename: str,
    out_dir: str,
    n_shards: int,
    kind: str = "single",
    policy: str = "pack",
    n_workers: int = 1,
) -> "DocShardedIndex":
    """Partition by doc range and build one full index per shard.

    Unlike the list-sharded build (whose parts recombine into ONE
    index), each doc shard here is a self-contained index over its doc
    range — the multi-host serving topology where no host ever holds
    the whole index.  Each shard trains its own dictionaries on its own
    sub-collection (each host models its local data); global BM25
    statistics travel in the catalog.  ``n_workers > 1`` builds shards
    in parallel worker processes (shards are fully independent — on a
    real deployment each host builds its own).
    """
    catalog = partition_collection_by_doc(basename, out_dir, n_shards)
    _build_shard_indexes(out_dir, "shard", n_shards, kind, policy, n_workers)
    # the catalog is the completion sentinel: written only after every
    # shard index exists, so an interrupted build reruns cleanly
    np.savez(os.path.join(out_dir, "catalog"), **catalog)
    return DocShardedIndex.load(out_dir)


class DocShardedIndex:
    """A set of per-doc-range indexes + the global-statistics catalog."""

    def __init__(self, shards, doc_lo, doc_hi, num_docs, df):
        self.shards = shards
        self.doc_lo = np.asarray(doc_lo, np.int64)
        self.doc_hi = np.asarray(doc_hi, np.int64)
        self.num_docs = int(num_docs)
        self.df = np.asarray(df, np.int64)

    @classmethod
    def load(cls, out_dir: str) -> "DocShardedIndex":
        with np.load(os.path.join(out_dir, "catalog.npz")) as z:
            S = int(z["n_shards"])
            lo, hi = np.array(z["doc_lo"]), np.array(z["doc_hi"])
            num_docs, df = int(z["num_docs"]), np.array(z["df"])
        shards = [
            dint_index.DintIndex.load(os.path.join(out_dir, f"shard{j}.idx"))
            for j in range(S)
        ]
        return cls(shards, lo, hi, num_docs, df)


def partition_collection_by_term(
    basename: str, out_dir: str, n_shards: int
) -> dict:
    """Split a collection into contiguous TERM-range shard collections.

    The complementary partitioning to partition_collection_by_doc:
    shard j owns terms [tlo[j], thi[j]) and holds their complete
    posting lists (docids stay GLOBAL — every shard spans all
    documents).  Returns the catalog: term ranges, global num_docs, and
    the global per-term document frequencies.
    """
    from ..io.collection import write_freq_collection

    view = open_freq_collection(basename)
    L = len(view)
    S = n_shards
    bounds = np.linspace(0, L, S + 1).astype(np.int64)
    docs = []
    freqs = []
    df: List[int] = []
    for d, f in view:
        df.append(d.shape[0])
        docs.append(d)
        freqs.append(f)
    os.makedirs(out_dir, exist_ok=True)
    for j in range(S):
        a, b = int(bounds[j]), int(bounds[j + 1])
        write_freq_collection(
            os.path.join(out_dir, f"tshard{j}"),
            docs[a:b],
            freqs[a:b],
            num_docs=view.num_docs,
        )
    return {
        "n_shards": S,
        "num_docs": view.num_docs,
        "term_lo": bounds[:-1],
        "term_hi": bounds[1:],
        "df": np.asarray(df, np.int64),
    }


def build_term_sharded(
    basename: str,
    out_dir: str,
    n_shards: int,
    kind: str = "single",
    policy: str = "pack",
    n_workers: int = 1,
) -> "TermShardedIndex":
    """Partition by term range and build one self-contained index per
    shard (each trains its own dictionaries on its own term subset —
    the term-partitioned multi-host layout of SURVEY §2.6; global BM25
    statistics travel in the catalog, like build_doc_sharded)."""
    catalog = partition_collection_by_term(basename, out_dir, n_shards)
    _build_shard_indexes(out_dir, "tshard", n_shards, kind, policy, n_workers)
    np.savez(os.path.join(out_dir, "tcatalog"), **catalog)
    return TermShardedIndex.load(out_dir)


class TermShardedIndex:
    """A set of per-term-range indexes + the global-statistics catalog."""

    def __init__(self, shards, term_lo, term_hi, num_docs, df):
        self.shards = shards
        self.term_lo = np.asarray(term_lo, np.int64)
        self.term_hi = np.asarray(term_hi, np.int64)
        self.num_docs = int(num_docs)
        self.df = np.asarray(df, np.int64)

    def owner_of(self, term: int) -> int:
        j = int(np.searchsorted(self.term_hi, term, side="right"))
        assert self.term_lo[j] <= term < self.term_hi[j]
        return j

    @classmethod
    def load(cls, out_dir: str) -> "TermShardedIndex":
        with np.load(os.path.join(out_dir, "tcatalog.npz")) as z:
            S = int(z["n_shards"])
            lo, hi = np.array(z["term_lo"]), np.array(z["term_hi"])
            num_docs, df = int(z["num_docs"]), np.array(z["df"])
        shards = [
            dint_index.DintIndex.load(
                os.path.join(out_dir, f"tshard{j}.idx")
            )
            for j in range(S)
        ]
        return cls(shards, lo, hi, num_docs, df)


def build_index_sharded(
    basename: str,
    kind: str = "single",
    policy: str = "pack",
    cache_dir: str = ".",
    n_workers: int = 2,
    serial: bool = False,
) -> dint_index.DintIndex:
    """Build an index with the list space sharded over worker processes.

    ``serial=True`` runs the same range partition in-process (useful on
    1-core hosts and for determinism tests).  Output is identical to
    ``build_index`` by construction; tests assert it field-for-field.
    """
    from ..dictionary import builder as dict_builder

    view = open_freq_collection(basename)
    L = len(view)
    n_workers = max(1, min(n_workers, L or 1))
    # Train-once (or hit the cache) BEFORE workers launch, so every
    # worker loads the same dictionaries (reference build_model order).
    tools_common.log("building or loading dictionaries (docs, freqs)...")
    docs_dict = dict_builder.build_or_load_dict(
        basename + ".docs", True, kind, policy, cache_dir
    )
    freqs_dict = dict_builder.build_or_load_dict(
        basename + ".freqs", False, kind, policy, cache_dir
    )

    bounds = np.linspace(0, L, n_workers + 1).astype(int)
    ranges: List[Tuple[int, int]] = [
        (int(bounds[i]), int(bounds[i + 1])) for i in range(n_workers)
    ]
    tools_common.log(
        f"sharded encode: {L} lists over {n_workers} workers "
        f"({'serial' if serial else 'processes'})..."
    )
    with tempfile.TemporaryDirectory(prefix="dint_build_") as td:
        jobs = [
            (basename, kind, policy, cache_dir, a, b,
             os.path.join(td, f"part{i}.npz"))
            for i, (a, b) in enumerate(ranges)
        ]
        if serial or n_workers == 1:
            paths = [_build_part(j) for j in jobs]
        else:
            # spawn: no fork-inherited torch/numpy state; workers import
            # fresh (the multi-host shape, each worker a clean runtime)
            ctx = mp.get_context("spawn")
            with ctx.Pool(processes=n_workers) as pool:
                paths = pool.map(_build_part, jobs)
        parts = []
        for p in paths:
            with np.load(p + ("" if p.endswith(".npz") else ".npz")) as z:
                parts.append({k: np.array(z[k]) for k in _PART_KEYS})
    return concat_index_parts(
        kind, policy, view.num_docs, parts, docs_dict, freqs_dict
    )
