"""Target-compaction policies.

Reference: dictionary_building_utils.hpp.

* ``pack_policy`` (:241-292): dedup all selected targets, then drop any
  target that is a proper prefix of a longer surviving target; the flat
  table is the concatenation of survivors sorted by (size, lex).  The
  reference's O(n^2) prefix scan becomes a sorted-successor check: in
  pure lexicographic order all extensions of t immediately follow t, so
  t is a proper prefix of some other entry iff its successor starts
  with t.

* ``overlap_policy`` (:92-238): additionally drop substring-contained
  targets and greedily merge maximal prefix-suffix overlaps.  The
  reference's priority-queue merge is O(n^2) pair enumeration; we keep
  the substring-drop exact and implement the overlap merge greedily via
  suffix/prefix hash buckets (same cost model: each merged overlap saves
  `overlap` table words — table size only; encoded bpi is unaffected by
  the policy choice beyond which entries exist, which is identical).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Entry = Tuple[int, ...]


def dedup_sorted(targets: Sequence[Entry]) -> List[Entry]:
    """Unique targets sorted by (size, lex) — the reference's target_t order
    (dictionary_building_utils.hpp:36-43)."""
    return sorted(set(targets), key=lambda t: (len(t), t))


def pack_compact(targets_per_dict: Sequence[Sequence[Entry]]) -> List[Entry]:
    all_targets = [t for ts in targets_per_dict for t in ts]
    uniq = sorted(set(all_targets))  # pure lex: prefix sorts before extension
    keep = []
    for i, t in enumerate(uniq):
        nxt = uniq[i + 1] if i + 1 < len(uniq) else None
        is_prefix = nxt is not None and len(nxt) > len(t) and nxt[: len(t)] == t
        if not is_prefix:
            keep.append(t)
    return sorted(keep, key=lambda t: (len(t), t))


def _substring_filter(uniq: List[Entry]) -> List[Entry]:
    # mark all proper substrings of every entry; drop entries so marked
    # when a strictly longer entry contains them
    # (dictionary_building_utils.hpp:201-218).
    contained = set()
    entries = set(uniq)
    for u in uniq:
        L = len(u)
        for a in range(L):
            for b in range(a + 1, L + 1):
                if b - a < L:
                    s = u[a:b]
                    if s in entries:
                        contained.add(s)
    return [t for t in uniq if t not in contained]


def overlap_compact(targets_per_dict: Sequence[Sequence[Entry]]) -> List[Entry]:
    all_targets = [t for ts in targets_per_dict for t in ts]
    uniq = sorted(set(all_targets), key=lambda t: (len(t), t))
    survivors = _substring_filter(uniq)

    # Greedy prefix-suffix overlap merging via hash buckets: repeatedly
    # merge a pair (left, right) where a suffix of left equals a prefix
    # of right, longest overlaps first (>= 2, like the reference's
    # overlap > 1 threshold at :83-84).
    entries: List[Tuple[int, ...]] = list(survivors)
    changed = True
    while changed:
        changed = False
        alive = [True] * len(entries)
        prefix_map: Dict[Tuple[int, ...], List[int]] = {}
        for idx, e in enumerate(entries):
            for L in range(2, len(e) + 1):
                prefix_map.setdefault(e[:L], []).append(idx)
        new_entries: List[Tuple[int, ...]] = []
        max_len = max((len(e) for e in entries), default=0)
        # longest overlaps first; many disjoint merges per pass
        for L in range(max_len, 1, -1):
            for i, e in enumerate(entries):
                if not alive[i] or len(e) < L:
                    continue
                for j in prefix_map.get(e[-L:], ()):
                    if j != i and alive[j] and len(entries[j]) > L:
                        new_entries.append(e + entries[j][L:])
                        alive[i] = False
                        alive[j] = False
                        changed = True
                        break
        entries = [e for i, e in enumerate(entries) if alive[i]] + new_entries
    return entries


POLICIES = {"pack": pack_compact, "overlap": overlap_compact}
POLICY_NAMES = {"pack": "packed", "overlap": "overlapped"}
