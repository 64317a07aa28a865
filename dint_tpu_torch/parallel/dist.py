"""Ranks and process groups: the port's counterpart of a JAX mesh.

The reference is single-controller: one process puts arrays on a
``jax.sharding.Mesh`` and ``shard_map`` runs a step once per device
(``dint_tpu/parallel/steps.py`` ``make_shard_map``).  PyTorch's idiom is
SPMD: one process a rank, every rank calling the same function on its
own shard, the cross-rank reductions written out as collectives of
``torch.distributed``.  So ``make_shard_map`` has no counterpart here: a
step of ``steps.py`` is called on its rank's tensors inside a process
that ``run_ranks`` started, and takes the process group where the
reference names the mesh axis.

``run_ranks`` starts ``world`` processes with the *spawn* method (a
forked child would inherit the caller's threads, JAX's among them),
joins them through a ``file://`` rendezvous in a fresh temporary
directory (no port to collide), and gives them NCCL, one rank a card,
on ``cuda`` and gloo on ``cpu``; it never trades one backend for the
other.  Every collective and the whole run have deadlines: a rank that
fails or hangs ends the run with an error, never a hung caller.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..backend import resolve_device

TIMEOUT_S = 300.0  # a collective's deadline, and the run's by default
_POLL_S = 0.5


def to_numpy(x):
    """Tensors (in dicts, lists and tuples too) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def to_tensors(x, device):
    """Numpy arrays (in dicts, lists and tuples too) as tensors on
    ``device``; u32 arrays travel as int32 bit patterns."""
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)
    if isinstance(x, dict):
        return {k: to_tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_tensors(v, device) for v in x)
    return x


def _rank_main(fn, rank, world, device_type, init_file, args, timeout_s,
               results):
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
            backend = "gloo"
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = to_numpy(fn(rank, world, device, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def _raise_failures(world, failed, results, grace_s: float = 2.0):
    """Raise with every rank's failure: the first one reported may be a
    rank whose collective lost the rank that failed first."""
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            rank, ok, res = results.get(timeout=max(0.01,
                                                    end - time.monotonic()))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = res
    raise RuntimeError("\n".join(f"rank {r} of {world} failed:\n{tb}"
                                 for r, tb in sorted(failed.items())))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_ranks(fn, world: int, device="cuda", args=(),
              timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned ranks
    of one process group and return each rank's result (tensors as
    numpy), in rank order.

    ``fn`` must be importable by name (a module-level function), and
    ``args`` picklable.  ``device`` "cuda" gives rank r card r over NCCL
    (``world`` may not exceed the cards), "cpu" gives gloo ranks of one
    thread each.  A rank that raises, dies or outlives ``timeout_s``
    makes this raise, with every rank stopped."""
    d = resolve_device(device)
    if d.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(
            f"{world} NCCL ranks need {world} cards, this host has "
            f"{torch.cuda.device_count()}: NCCL runs one rank a card")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="dint_ranks_")
    procs = [
        ctx.Process(target=_rank_main,
                    args=(fn, r, world, d.type, os.path.join(tmp, "rdv"),
                          args, timeout_s, results))
        for r in range(world)
    ]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            try:
                rank, ok, res = results.get(timeout=_POLL_S)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that died may still have a report in flight
                    try:
                        rank, ok, res = results.get(timeout=5)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and no report")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within {timeout_s} s "
                        f"(done: {sorted(out)})")
                else:
                    continue
            if not ok:
                _raise_failures(world, {rank: res}, results)
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank of {world} did not exit")
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
