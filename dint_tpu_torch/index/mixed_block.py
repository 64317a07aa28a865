"""Space-time-optimal mixed-block index (mixed_block.hpp rebuild; host
copy of ``dint_tpu/index/mixed_block.py``).

Every block part (docs and freqs independently) carries a 1-byte codec
tag and is encoded with whichever candidate codec minimizes
``space_bytes + lam * predicted_decode_ns * access_count``
(mixed_block.hpp:119-150 candidate points; access counts from the
block profiler, :142-144; decode-time linear models from
dec_time_prediction).  With lam=0 (no predictor) the choice degenerates
to smallest-space, which already beats any single codec.

The candidate set mirrors the reference's {OptPFD, VarintG8IU,
interpolative} (:40-66) plus streamvbyte.  The container reuses the
BlockIndex SoA layout with codec="mixed".
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..codecs import blocks as blocks_mod
from ..config import BLOCK_SIZE
from ..io.collection import open_freq_collection
from ..tools import common as tools_common
from ..utils import dec_time_prediction as dtp
from ..utils import gaps as gap_mod
from .block_index import BlockIndex

CANDIDATES = ("optpfor", "varintg8iu", "interpolative", "streamvbyte")
_TAG = {c: i for i, c in enumerate(CANDIDATES)}


def mixed_encode(values, sum_of_values, predictor=None, access_count=1,
                 lam: float = 0.0) -> bytes:
    best = None
    best_cost = None
    for c in CANDIDATES:
        enc, _ = blocks_mod.CODECS[c]
        try:
            body = enc(values, sum_of_values)
        except (ValueError, AssertionError):
            continue
        cost = float(len(body))
        if predictor is not None and lam > 0:
            pb, pe = dtp.pfor_features(c, body, len(values))
            feats = dtp.feature_vector(values, len(body), pb, pe)
            cost += lam * predictor.predict(c, feats) * access_count
        if best_cost is None or cost < best_cost:
            best_cost = cost
            best = bytes([_TAG[c]]) + body
    assert best is not None
    return best


def mixed_decode(buf, pos, n, sum_of_values):
    tag = int(buf[pos])
    _, dec = blocks_mod.CODECS[CANDIDATES[tag]]
    return dec(buf, pos + 1, n, sum_of_values)


# register as a codec so BlockIndex machinery can decode it
blocks_mod.CODECS["mixed"] = (
    lambda v, s: mixed_encode(v, s),
    mixed_decode,
)


def build_mixed_index(
    basename: str,
    predictor: Optional[dtp.Predictor] = None,
    access_counts: Optional[Dict[int, np.ndarray]] = None,
    lam: float = 0.0,
) -> BlockIndex:
    """block_transformer analogue (mixed_block.hpp:152-195): choose the
    best codec per block, optionally weighted by profiled accesses."""
    view = open_freq_collection(basename)
    tools_common.log("encoding posting lists (mixed blocks)...")
    list_n: List[int] = []
    block_ptr = [0]
    block_max: List[int] = []
    docs_end: List[int] = []
    block_end: List[int] = []
    parts: List[bytes] = []
    pos = 0
    for t, (docs, freqs) in enumerate(view):
        n = int(docs.shape[0])
        list_n.append(n)
        dgaps = gap_mod.docs_to_gaps(docs)
        fgaps = gap_mod.freqs_to_gaps(freqs)
        base = 0
        counts = access_counts.get(t) if access_counts else None
        for bi, p in enumerate(range(0, n, BLOCK_SIZE)):
            size = min(BLOCK_SIZE, n - p)
            last_doc = int(docs[p + size - 1])
            block_max.append(last_doc)
            d_acc = int(counts[0, bi]) if counts is not None else 1
            f_acc = int(counts[1, bi]) if counts is not None else 1
            db = mixed_encode(
                dgaps[p : p + size], last_doc - base - (size - 1),
                predictor, d_acc, lam,
            )
            fb = mixed_encode(
                fgaps[p : p + size], blocks_mod.UNKNOWN, predictor, f_acc, lam
            )
            parts.append(db)
            pos += len(db)
            docs_end.append(pos)
            parts.append(fb)
            pos += len(fb)
            block_end.append(pos)
            base = last_doc + 1
        block_ptr.append(len(block_max))
    return BlockIndex(
        "mixed",
        view.num_docs,
        np.asarray(list_n, np.uint32),
        np.asarray(block_ptr, np.uint64),
        np.asarray(block_max, np.uint32),
        np.asarray(docs_end, np.uint64),
        np.asarray(block_end, np.uint64),
        np.frombuffer(b"".join(parts), dtype=np.uint8),
    )
