"""DSF ("Decreasing Static Frequencies") dictionary building.

Reference: dictionary_builders.hpp:40-76 — take the top ``num_entries``
filtered blocks per selector context (already sorted by freq desc /
length desc by the statistics stage) and append them to the dictionary
builder; the policy compaction happens inside the dictionary build.

Caching mirrors dict_freq_index.hpp:139-161: dictionaries persist to
``dict.<collection-file>.<dict-type>.DSF-<entries>-<entry-size>`` and
are loaded when present.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..config import MAX_ENTRY_SIZE, NUM_ENTRIES, NUM_SELECTORS, RESERVED
from ..stats.block_stats import BlockStats, SelectorStats, create_or_load
from .dictionary import (
    MultiPackedDictionary,
    PackedDictionary,
    RectangularDictionary,
)

Entry = Tuple[int, ...]


def dsf_type_name() -> str:
    return f"DSF-{NUM_ENTRIES}-{MAX_ENTRY_SIZE}"


def targets_from_stats(ctx: SelectorStats, cap: int = NUM_ENTRIES - RESERVED) -> List[Entry]:
    n = min(cap, ctx.lengths.shape[0])
    out: List[Entry] = []
    for i in range(n):
        ln = int(ctx.lengths[i])
        out.append(tuple(int(x) for x in ctx.data[i, :ln]))
    return out


def build_dictionary(stats: BlockStats, kind: str, policy: str = "pack"):
    """kind in {'rectangular', 'single', 'multi'}."""
    if kind == "multi":
        assert stats.is_multi
        targets = [targets_from_stats(ctx) for ctx in stats.contexts]
        while len(targets) < NUM_SELECTORS:
            targets.append([])
        return MultiPackedDictionary.build(targets, policy)
    targets = targets_from_stats(stats.contexts[0])
    if kind == "rectangular":
        return RectangularDictionary.build(targets)
    return PackedDictionary.build(targets, policy)


def dict_cache_name(collection_path: str, kind: str, policy: str = "pack") -> str:
    base = os.path.basename(collection_path)
    if kind == "rectangular":
        tname = RectangularDictionary.type_name()
    elif kind == "multi":
        tname = MultiPackedDictionary.type_name(policy)
    else:
        tname = PackedDictionary.type_name(policy)
    return f"dict.{base}.{tname}.{dsf_type_name()}"


def build_or_load_dict(
    collection_path: str,
    compute_gaps: bool,
    kind: str,
    policy: str = "pack",
    cache_dir: str = ".",
):
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, dict_cache_name(collection_path, kind, policy))
    if os.path.exists(cache):
        if kind == "rectangular":
            return RectangularDictionary.load(cache)
        if kind == "multi":
            return MultiPackedDictionary.load(cache, policy)
        return PackedDictionary.load(cache, policy)
    stats = create_or_load(
        collection_path, compute_gaps, multi=(kind == "multi"), cache_dir=cache_dir
    )
    d = build_dictionary(stats, kind, policy)
    try:
        d.store(cache)
    except OSError:
        pass
    return d
