"""One run of one cell: set-up, the measured window, the traced slice,
the check, and the result line.

``run_cell`` drives the cell's traffic kind (``kinds/<kind>.py``):
``setup(ctx)``, ``window(state, seconds)``, ``traced_work(state)``,
``release(state)`` and ``check(state)``.  The result holds the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``), the device, and last every number the check compared beside its
limit.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from . import profiling
from .spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "dint_tpu")


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    workdir: str
    spans: Spans = field(default_factory=Spans)
    facts: dict = field(default_factory=dict)  # counts the readers use


@dataclass
class Readings:
    """What a per-layer metric's reader reads."""
    spans: Spans  # set-up and the window, not the traced slice
    facts: dict
    profile: dict  # profiling.profile's result, or None
    work: int  # work units (runs, batches) of the traced slice
    device_kind: str


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def run_cell(man, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None) -> dict:
    """The result line's object for one run."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = man.cell(cell_name)
    cfg = man.config(cell["config"])
    tr = man.traffic(cell["traffic"])
    kind = man.kind(tr["kind"])
    root = os.environ.get("TMPDIR") or None
    workdir = tempfile.mkdtemp(prefix="bench-data-", dir=root)
    try:
        ctx = Context(cfg, tr, int(seed), device, workdir)
        with contextlib.redirect_stdout(sys.stderr):
            st = kind.setup(ctx)
            setup_s = time.perf_counter() - t_start
            e2e = kind.window(st, float(seconds))
            window_spans = ctx.spans.snapshot()
            prof, work = None, 0
            if trace:
                fn, work = kind.traced_work(st)
                prof = profiling.profile(fn, workdir, device)
            peak = _peak(device)
            st = kind.release(st)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            checks = kind.check(st)
    finally:
        print(f"data written to {workdir}: {_tree_bytes(workdir)} B",
              file=sys.stderr)
        shutil.rmtree(workdir, ignore_errors=True)
    values = dict(e2e)
    values["setup_s"] = setup_s
    values["device_B_per_int"] = peak / ctx.facts["postings"]
    kind_name = device_kind(device)
    if trace:
        readings = Readings(window_spans, ctx.facts, prof, work, kind_name)
        metrics = {}
        for m in man.per_layer(cell_name):
            v = man.metric_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in man.end_to_end(cell_name)
                   if m["name"] in values}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind_name,
           "count": int(cell["chips"]),
           "memory_peak_bytes": peak}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": int(e2e["attempted"]),
           "failed": int(st.get("failed", 0)),
           "metrics": metrics, "device": dev}
    if trace and prof is not None:
        dev["busy_s"] = prof["busy_s"] or 0.0
        dev["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out
