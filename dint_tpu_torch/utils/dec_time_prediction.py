"""Per-codec decode-time prediction (host copy; dec_time_prediction.hpp +
dec_time_regression.py rebuild).

Features per block (dec_time_prediction.hpp:13,108-143): n, encoded
size, sum of log2(1+v), entropy estimate, nonzero count, max bit width,
plus a constant.  A per-codec linear model predicts decode nanoseconds;
`train` fits models from measured (features, time) samples — the
reference trains offline with a pandas L1 solver
(dec_time_regression.py:19-76); we use iteratively-reweighted least
squares for the same robust-L1 behavior, self-contained in numpy.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

FEATURES = ("const", "n", "size", "sum_of_logs", "entropy", "nonzeros",
            "max_b", "pfor_b", "pfor_exceptions")


def feature_vector(
    values: np.ndarray, encoded_size: int,
    pfor_b: int = 0, pfor_exceptions: int = 0,
) -> np.ndarray:
    """The reference's full feature set (dec_time_prediction.hpp:13):
    the codec-specific pfor_b / pfor_exceptions are nonzero only for
    OptPFD blocks (mixed_block.hpp:79-97 fills them from the chosen b
    and its exception census; every other codec passes 0)."""
    v = np.asarray(values, dtype=np.float64)
    n = v.shape[0]
    logs = np.log2(1.0 + v)
    # entropy of the value distribution (coarse, like values_statistics)
    uniq, counts = np.unique(v, return_counts=True)
    p = counts / max(n, 1)
    entropy = float(-(p * np.log2(p)).sum()) if n else 0.0
    max_b = int(v.max()).bit_length() if n else 0
    return np.asarray(
        [1.0, n, encoded_size, float(logs.sum()), entropy,
         float((v != 0).sum()), max_b, pfor_b, pfor_exceptions],
        dtype=np.float64,
    )


def pfor_features(codec: str, body: bytes, n: int):
    """(pfor_b, pfor_exceptions) extracted from an encoded optpfor
    block body (header = b u8, #exceptions u16 LE — see
    codecs/blocks.py optpfor_decode); (0, 0) for every other codec and
    for partial blocks (n < 256 encodes as interpolative, whose bits
    are not a pfor header)."""
    if codec != "optpfor" or n < 256 or len(body) < 3:
        return 0, 0
    return int(body[0]), int.from_bytes(bytes(body[1:3]), "little")


@dataclass
class Predictor:
    weights: Dict[str, np.ndarray] = field(default_factory=dict)

    def predict(self, codec: str, feats: np.ndarray) -> float:
        w = self.weights.get(codec)
        if w is None:
            return 0.0
        return float(np.dot(w, feats))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({k: v.tolist() for k, v in self.weights.items()}, f)

    @classmethod
    def load(cls, path: str) -> "Predictor":
        with open(path) as f:
            raw = json.load(f)
        return cls({k: np.asarray(v, dtype=np.float64) for k, v in raw.items()})


def fit_l1(X: np.ndarray, y: np.ndarray, iters: int = 30) -> np.ndarray:
    """Robust L1 regression via iteratively reweighted least squares."""
    w = np.linalg.lstsq(X, y, rcond=None)[0]
    for _ in range(iters):
        r = np.abs(y - X @ w)
        wt = 1.0 / np.maximum(r, 1e-9)
        Xw = X * wt[:, None]
        w = np.linalg.lstsq(Xw.T @ X, Xw.T @ y, rcond=None)[0]
    return w


def train(samples: Dict[str, List]) -> Predictor:
    """samples: {codec: [(features, nanos), ...]} -> fitted Predictor."""
    pred = Predictor()
    for codec, rows in samples.items():
        X = np.stack([f for f, _ in rows])
        y = np.asarray([t for _, t in rows], dtype=np.float64)
        pred.weights[codec] = fit_l1(X, y)
    return pred


def measure_block_decode(codec: str, blocks: List[np.ndarray], reps: int = 5):
    """Measure host decode times for training samples."""
    from ..codecs import blocks as blocks_mod

    enc, dec = blocks_mod.CODECS[codec]
    rows = []
    for vals in blocks:
        buf = enc(vals, blocks_mod.UNKNOWN)
        arr = np.frombuffer(buf, np.uint8)
        t0 = time.perf_counter()
        for _ in range(reps):
            dec(arr, 0, vals.shape[0], blocks_mod.UNKNOWN)
        t1 = time.perf_counter()
        pb, pe = pfor_features(codec, buf, vals.shape[0])
        rows.append(
            (feature_vector(vals, len(buf), pb, pe), (t1 - t0) / reps * 1e9)
        )
    return rows
