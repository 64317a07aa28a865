"""Rank bodies for the port's multi-process tests.

``dint_tpu_torch.parallel.dist.run_ranks`` starts its ranks with the
spawn method, so a rank body must be importable by name in a fresh
interpreter.  The bodies live here, apart from the test modules, so that
a rank imports torch and the port only, never JAX or the reference.
"""

from __future__ import annotations

import numpy as np

from dint_tpu_torch.parallel import dist as pdist
from dint_tpu_torch.parallel import steps


def steps_body(rank, world, device, cases):
    """``cases`` {name: (step name, per-rank args, kwargs)}: this rank
    calls ``steps.<step>(*args[rank], **kwargs)`` with the numpy arrays
    of its args as tensors on its device; returns {name: outputs}."""
    out = {}
    for name, (step, per_rank, kwargs) in cases.items():
        args = pdist.to_tensors(per_rank[rank], device)
        out[name] = getattr(steps, step)(*args, **kwargs)
    return out


def serve_body(rank, world, device, paths, queries, and_queries, k):
    """Every sharded serve on this rank: the doc- and term-range shard
    sets of ``world`` shards, the boolean AND over the doc shards, and
    one index doc-sharded, unpruned and pruned."""
    from dint_tpu_torch.index import dint_index
    from dint_tpu_torch.parallel import build as pbuild
    from dint_tpu_torch.parallel import serve
    from dint_tpu_torch.query import ranked
    from dint_tpu_torch.query.term_decode import TermDecoder

    wdata = ranked.WandData.load(paths["wand"])
    dsh = pbuild.DocShardedIndex.load(paths["doc_shards"])
    tsh = pbuild.TermShardedIndex.load(paths["term_shards"])
    idx = dint_index.DintIndex.load(paths["index"])
    dec = TermDecoder(idx, device=device)
    return {
        "doc": serve.serve_ranked_doc_sharded(
            None, dsh, wdata.norm_lens, queries, k=k, device=device),
        "term": serve.serve_ranked_term_sharded(
            None, tsh, wdata.norm_lens, queries, k=k, device=device),
        "and": serve.serve_boolean_doc_sharded(None, dsh, and_queries,
                                               device=device),
        "unpruned": serve.serve_ranked_sharded(
            None, idx, dec, wdata, queries, k=k, pruned=False),
        "pruned": serve.serve_ranked_sharded(
            None, idx, dec, wdata, queries, k=k, pruned=True),
    }


def failing_body(rank, world, device):
    """Rank 1 raises; the others wait in a collective it never joins."""
    import torch
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
    return np.asarray(t)


def sleeping_body(rank, world, device, seconds):
    """Outlives any short deadline."""
    import time

    time.sleep(seconds)
    return rank
