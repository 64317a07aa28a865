"""The seed's collection: docid lists made from ``--seed``.

After the generator of ``dint_tpu_torch/io/synth.py`` (``make_collection``
in its ``target_postings`` mode: ``zipf_lengths``, ``random_posting_list``),
frozen here so that a later change to the port's generator cannot change
what the benchmark feeds it, and drawn for every list at once (one draw
of each kind over all postings, not one a list), so that half a million
lists cost no more than a few large numpy calls.

Every seed gets the same multiset of list lengths (the rank-frequency
law of ``zipf_lengths`` has no randomness but its order), so every seed
does the same amount of work; the seed decides which list gets which
length, and the docids.  The file is written in the ds2i binary format
(a u32 length before each sequence; ``.docs`` starts with the one-int
sequence ``[num_docs]``), which the port reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed``, any whole number (negative and past 64
    bits included), and a sub-stream id."""
    return np.random.default_rng([seed % (1 << 64), stream])


def zipf_lengths(num_lists: int, target_sum: int, cap: int) -> np.ndarray:
    """List lengths in rank order, cap * rank^-alpha with alpha found so
    that the total is ``target_sum`` exactly, each in [1, cap] (copy of
    ``io/synth.zipf_lengths`` without its shuffle: the seed orders the
    lists, so the multiset is the same for every seed)."""
    ranks = np.arange(1, num_lists + 1, dtype=np.float64)

    def lens_of(alpha: float) -> np.ndarray:
        return np.maximum(1, np.round(cap * ranks ** -alpha)).astype(np.int64)

    lo, hi = 0.0, 12.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if int(lens_of(mid).sum()) > target_sum:
            lo = mid
        else:
            hi = mid
    lens = lens_of(lo)
    diff = int(lens.sum()) - target_sum
    i = 0
    order = np.argsort(-lens, kind="stable")
    while diff != 0 and i < num_lists:
        j = order[i % num_lists]
        if diff > 0 and lens[j] > 1:
            lens[j] -= 1
            diff -= 1
        elif diff < 0 and lens[j] < cap:
            lens[j] += 1
            diff += 1
        i += 1
    return lens


def posting_lists(rng, universe: int, lens: np.ndarray,
                  cluster: float = 0.3) -> np.ndarray:
    """Strictly increasing docids over [0, universe) for lists of
    ``lens``, list after list, as one u32 array.  In each list a gap is
    1 with probability ``cluster``, else 1 + a geometric extra whose
    mean spreads the list over the universe; a list whose extras would
    pass the universe has them scaled down (``io/synth.
    random_posting_list``'s rule, drawn for all lists at once)."""
    lens = np.asarray(lens, np.int64)
    assert (lens > 0).all() and (lens <= universe).all()
    total = int(lens.sum())
    starts = np.zeros(lens.shape[0], np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    of = np.repeat(np.arange(lens.shape[0], dtype=np.int32), lens)
    mean_extra = np.maximum((universe / lens - 1.0)
                            / max(1e-9, 1.0 - cluster), 0.001)
    p = np.minimum(1.0, 1.0 / (1.0 + mean_extra))
    extra = rng.geometric(p[of]) - 1
    extra[rng.random(total) < cluster] = 0
    ext_sum = np.add.reduceat(extra, starts)
    over = lens + ext_sum > universe
    if over.any():
        scale = np.ones(lens.shape[0])
        scale[over] = ((universe - lens[over]) * 0.98
                       / np.maximum(ext_sum[over], 1))
        extra = (extra * scale[of]).astype(np.int64)
    steps = extra + 1
    ends = np.cumsum(steps)
    docs = ends - np.repeat(ends[starts] - steps[starts], lens) - 1
    assert int(docs.max()) < universe
    return docs.astype(np.uint32)


@dataclass
class Collection:
    docs: np.ndarray  # u32 docids of every list, list after list
    lengths: np.ndarray  # int64, the length of each list
    num_docs: int

    @property
    def starts(self) -> np.ndarray:
        """Where each list starts in ``docs``."""
        s = np.zeros(self.lengths.shape[0], np.int64)
        np.cumsum(self.lengths[:-1], out=s[1:])
        return s

    @property
    def postings(self) -> int:
        return int(self.lengths.sum())


def make(shape: dict, seed: int) -> Collection:
    """The collection of a configuration's ``collection`` block for
    ``seed``: ``num_lists`` lists over ``num_docs`` docs holding
    ``num_postings`` postings, docids clustered with ``cluster``."""
    num_docs = int(shape["num_docs"])
    lens = zipf_lengths(int(shape["num_lists"]), int(shape["num_postings"]),
                        num_docs)
    rng = rng_of(seed)
    lens = rng.permutation(lens)
    docs = posting_lists(rng, num_docs, lens, float(shape["cluster"]))
    return Collection(docs, lens, num_docs)


def write(base: str, coll: Collection) -> int:
    """Write ``base``.docs in the ds2i length-prefixed format in one
    pass; returns the bytes written."""
    os.makedirs(os.path.dirname(os.path.abspath(base)), exist_ok=True)
    n_lists = coll.lengths.shape[0]
    out = np.empty(2 + n_lists + coll.postings, dtype="<u4")
    out[0], out[1] = 1, coll.num_docs
    heads = 2 + coll.starts + np.arange(n_lists)
    out[heads] = coll.lengths
    body = np.ones(out.shape[0], bool)
    body[:2] = False
    body[heads] = False
    out[body] = coll.docs
    out.tofile(base + ".docs")
    return out.nbytes
