"""A copy of the benchmark's manifest and files at a tiny size, for runs
on the CPU."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.manifest import BENCH_DIR, ROOT

# gaps past 2^16 (the control's precision) come from the short lists
# over 100,000 docs; the longest list holds every doc
TINY_COLLECTION = {"num_lists": 1000, "num_docs": 100000,
                   "num_postings": 150000, "cluster": 0.3}
TINY_TRAFFIC = {"scan": {"runs_per_call": 2, "warmup_calls": 1,
                         "trace_calls": 1}}


def run(man, cell: str, seed: int = 2**31 + 7, trace: bool = False,
        seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU."""
    from benchmark import harness

    return harness.run_cell(man, cell, seed, seconds, trace, "cpu")


def make(root: str) -> str:
    """Write the tiny copy under ``root``; returns its manifest path."""
    bench = os.path.join(root, "benchmark")
    for sub in ("traffic", "metrics", "kinds"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["collection"] = dict(TINY_COLLECTION)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name, over in TINY_TRAFFIC.items():
        path = os.path.join(bench, "traffic", name + ".json")
        with open(path) as f:
            tr = json.load(f)
        tr.update(over)
        with open(path, "w") as f:
            json.dump(tr, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(man, f)
    return path
