"""Device busy time, idle gaps and the top device operations of a traced
slice of work, from torch.profiler's trace.

The busy-time arithmetic is a copy of ``profile_runs`` in
``dint_tpu_torch/tools/scale_test.py``: busy is the union of the card's
kernel, memset and memcpy intervals.  Idle gaps are the stretches of
the slice between them; each is named by what the host was doing when
it began: the innermost benchmark span and the innermost host operation
open at that moment.
"""

from __future__ import annotations

import bisect
import json
import os
import time

import torch

from .spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
TOP = 10


def profile(work, trace_dir: str, device: torch.device) -> dict:
    """Run ``work()`` under torch.profiler and return ``busy_s``,
    ``window_s`` (host wall of the slice, which ends in a synchronize),
    the top device operations and the longest idle gaps.  ``busy_s`` is
    None where the trace holds no device interval.  ``work`` runs twice,
    the first time traced and thrown away: the profiler's first cycle
    pays its own start-up on the host (on the H100, 51% idle against 10%
    for the same 512 chained decodes traced again)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts):
        work()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_events(events, wall)


def reduce_events(events, wall_s: float) -> dict:
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in DEVICE_CATS and "dur" in e)
    out = {"window_s": wall_s, "busy_s": None, "device_ops": [],
           "idle_gaps": []}
    if not dev:
        return out
    busy, end, by_name, gaps = 0.0, dev[0][0], {}, []
    for a, b, name in dev:
        if a > end:
            gaps.append((a - end, end))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    out["busy_s"] = busy * 1e-6
    out["device_ops"] = [[n[:120], s * 1e-6] for n, s in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("user_annotation", "cpu_op")
                  and "dur" in e)
    starts = [h[0] for h in host]
    named = []
    for dur, at in sorted(gaps, reverse=True)[:TOP]:
        named.append([_host_at(host, starts, at), dur * 1e-6])
    out["idle_gaps"] = named
    return out


def _host_at(host, starts, t) -> str:
    """The innermost benchmark span and host operation open at ``t``."""
    span, op, span_start, op_start = "none", "", -1.0, -1.0
    for a, b, name in host[:bisect.bisect_right(starts, t)]:
        if a <= t <= b:
            if name.startswith(PREFIX):
                if a >= span_start:
                    span, span_start = name[len(PREFIX):], a
            elif a >= op_start:
                op, op_start = name, a
    return f"{span}/{op}"[:120] if op else span
