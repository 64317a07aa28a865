"""Ranked retrieval: BM25 scoring, wand_data, the exhaustive top-k oracle.

The port's copy of the host part of ``dint_tpu/query/ranked.py``.  BM25
constants and formulas match bm25.hpp:7-25 exactly (k1=1.2, b=0.5, idf
floored at 1e-6, query weight scaled by (1+k1)); wand_data matches
wand_data.hpp:17-53 (lengths normalized by the average, per-term max
doc_term_weight), plus the per-256-block max weights.

`ranked_or` is the exhaustive union scorer — the oracle the reference's
own tests compare WAND/maxscore against (test_ranked_queries.cpp:43-55).
`wand`, `maxscore` and `ranked_and` walk skipping cursors over the lazy
block decoder and are not ported yet: ROADMAP.md 'Modules still to port'
item 1 (the BMW slice).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from ..io.collection import open_freq_collection, read_sizes_file

K1 = 1.2
B = 0.5
EPS_SCORE = 1e-6


def doc_term_weight(freq: np.ndarray, norm_len: np.ndarray) -> np.ndarray:
    f = freq.astype(np.float32)
    return f / (f + np.float32(K1) * (1.0 - B + B * norm_len.astype(np.float32)))


def query_term_weight(qf: int, df: int, num_docs: int) -> float:
    idf = np.log((float(num_docs) - df + 0.5) / (df + 0.5))
    return float(qf) * max(EPS_SCORE, float(idf)) * (1.0 + K1)


@dataclass
class WandData:
    """wand_data sidecar (wand_data.hpp) + per-block extension: per-doc
    normalized lengths, one max term weight per term, and a per-256-block
    max doc_term_weight (``block_maxw`` flat over blocks in list order,
    ``block_ptr`` the per-term offsets).  Its ``.npz`` file is the
    reference package's."""

    norm_lens: np.ndarray  # (num_docs,) f32, lengths / avg length
    max_term_weight: np.ndarray  # (num_terms,) f32
    block_maxw: Optional[np.ndarray] = None  # (NB,) f32 per-block max dtw
    block_ptr: Optional[np.ndarray] = None  # (num_terms+1,) i64

    def save(self, path: str) -> None:
        extra = {}
        if self.block_maxw is not None:
            extra = {"block_maxw": self.block_maxw, "block_ptr": self.block_ptr}
        np.savez(
            path,
            norm_lens=self.norm_lens,
            max_term_weight=self.max_term_weight,
            **extra,
        )

    @classmethod
    def load(cls, path: str) -> "WandData":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(
            z["norm_lens"],
            z["max_term_weight"],
            z["block_maxw"] if "block_maxw" in z else None,
            z["block_ptr"] if "block_ptr" in z else None,
        )


def build_wand_data(basename: str, block_max: bool = True) -> WandData:
    """create_wand_data equivalent (src/create_wand_data.cpp); also
    computes the per-256-block max weights unless ``block_max=False``."""
    sizes = read_sizes_file(basename).astype(np.float64)
    norm = (sizes / sizes.mean()).astype(np.float32)
    view = open_freq_collection(basename)
    maxw = np.zeros(len(view), dtype=np.float32)
    block_ptr = np.zeros(len(view) + 1, dtype=np.int64)
    bmw_parts: List[np.ndarray] = []
    for i, (docs, freqs) in enumerate(view):
        w = doc_term_weight(freqs, norm[docs.astype(np.int64)])
        maxw[i] = w.max() if w.shape[0] else 0.0
        if block_max:
            nb = -(-w.shape[0] // BLOCK_SIZE)
            block_ptr[i + 1] = block_ptr[i] + nb
            if nb:
                pad = np.zeros(nb * BLOCK_SIZE, dtype=np.float32)
                pad[: w.shape[0]] = w
                bmw_parts.append(pad.reshape(nb, BLOCK_SIZE).max(axis=1))
    if block_max:
        flat = (
            np.concatenate(bmw_parts)
            if bmw_parts
            else np.zeros(0, np.float32)
        )
        return WandData(norm, maxw, flat.astype(np.float32), block_ptr)
    return WandData(norm, maxw)


def query_weights_from(
    df: np.ndarray, num_docs: int, terms: Sequence[int]
) -> List[Tuple[int, float]]:
    """(term, q_weight) pairs from explicit global statistics;
    duplicate query terms raise qf (wand_query ctor semantics,
    queries.hpp:209-222)."""
    qf: Dict[int, int] = {}
    for t in terms:
        qf[int(t)] = qf.get(int(t), 0) + 1
    out = []
    for t, f in sorted(qf.items()):
        out.append((t, query_term_weight(f, int(df[t]), num_docs)))
    return out


def _query_weights(index, terms: Sequence[int]) -> List[Tuple[int, float]]:
    return query_weights_from(index.list_n, index.num_docs, terms)


def ranked_or(index, decoder, wdata: WandData, terms: Sequence[int],
              k: int = 10) -> np.ndarray:
    """Exhaustive union scoring; returns top-k scores descending."""
    weighted = _query_weights(index, terms)
    if not weighted:
        return np.zeros(0, dtype=np.float32)
    tlist = [t for t, _ in weighted]
    docs = decoder.decode_docids(tlist)
    freqs = decoder.decode_freqs(tlist)
    all_docs = np.concatenate([docs[t] for t in tlist])
    all_scores = np.concatenate(
        [
            np.float32(qw)
            * doc_term_weight(freqs[t], wdata.norm_lens[docs[t].astype(np.int64)])
            for t, qw in weighted
        ]
    )
    if all_docs.shape[0] == 0:  # every query term has an empty list
        return np.zeros(0, dtype=np.float32)
    order = np.argsort(all_docs, kind="stable")
    d = all_docs[order]
    s = all_scores[order]
    boundary = np.empty(d.shape[0], dtype=bool)
    boundary[0] = True
    boundary[1:] = d[1:] != d[:-1]
    starts = np.flatnonzero(boundary)
    sums = np.add.reduceat(s, starts)
    top = np.sort(sums)[::-1][:k]
    return top.astype(np.float32)
