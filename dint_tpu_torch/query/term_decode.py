"""Batched decoding of index posting lists for query execution.

The port of ``dint_tpu/query/term_decode.py``.  Gathers every needed
block of the queried terms into one decode plan (full DINT blocks through
``LocalDecodeEngine`` on ``device``: the class kernels K1-K3 on the card,
then the docid rebuild as torch ops; partial interpolative blocks on the
host), and rebuilds docIDs per block — each block is independent because
block bases come from block_maxs (dict_posting_list.hpp:284-309
semantics, batched).

``timings`` accumulates the wall seconds of each host and device phase
(plan, upload, decode, gather_units, partial, assemble) over every
batch this decoder decoded.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..codecs import interpolative
from ..config import BLOCK_SIZE, NUM_SELECTORS
from ..kernels import decode_local


class TermDecoder:
    """Decodes docID and freq lists for sets of terms on ``device``."""

    def __init__(self, index, device="cuda"):
        self.device = resolve_device(device)
        self.index = index
        index.ensure_docs_end()
        self.docs_view = index.docs_dict.decode_view()
        self.freqs_view = index.freqs_dict.decode_view()
        self._doc_cache: Dict[int, np.ndarray] = {}
        self._freq_cache: Dict[int, np.ndarray] = {}
        self.timings: Dict[str, float] = {}
        self._lazy_cache = None
        self._lazy_totals = None  # tools.queries.run_op's counter sums

    @property
    def lazy_cache(self):
        """Skip-aware per-block decoder shared by WAND/maxscore/lazy AND
        (query/lazy_decode.py): decodes only the blocks skips land in.
        Host numpy, whatever ``device`` is."""
        if self._lazy_cache is None:
            from .lazy_decode import BlockCache

            self._lazy_cache = BlockCache(self.index)
        return self._lazy_cache

    def _tick(self, phase: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.timings[phase] = self.timings.get(phase, 0.0) + (t1 - t0)
        return t1

    # ---- block geometry ----
    def _block_geometry(self, terms: Sequence[int]):
        idx = self.index
        rows = []  # (term, block_id, pos_in_list, size, base)
        for t in terms:
            p0, p1 = idx.list_blocks(t)
            n = int(idx.list_n[t])
            for b in range(p0, p1):
                pos = (b - p0) * BLOCK_SIZE
                size = min(BLOCK_SIZE, n - pos)
                base = int(idx.block_max[b - 1]) + 1 if b > p0 else 0
                rows.append((t, b, pos, size, base))
        return rows

    def _decode_units(
        self, starts, byte_lens, sizes, view, b_bits, ctxs, bases=None
    ) -> List[np.ndarray]:
        """Decode DINT units through the class-split engine: plan once per
        term batch with the native planner, one run of the class kernels.

        With ``bases`` (per-unit docid bases from block_maxs) the docid
        rebuild runs on the device after the gather
        (decode_local._docid_rebuild) and the returned arrays are docids
        rather than gaps."""
        t0 = time.perf_counter()
        plan = decode_local.plan_stream(
            self.index.arena, np.asarray(starts), np.asarray(byte_lens),
            np.asarray(sizes), np.asarray(ctxs), np.asarray(b_bits), view,
        )
        t0 = self._tick("plan", t0)
        engine = decode_local.LocalDecodeEngine(plan, device=self.device)
        t0 = self._tick("upload", t0)
        if bases is not None:
            outs = engine.decode_docids_all(np.asarray(bases, np.uint32))
        else:
            outs = engine.decode_all()
        if outs.is_cuda:
            torch.cuda.synchronize(outs.device)
        t0 = self._tick("decode", t0)
        res = engine.gather_units(outs, len(starts), sizes)
        self._tick("gather_units", t0)
        return res

    def decode_docids(self, terms: Sequence[int]) -> Dict[int, np.ndarray]:
        """{term: docids} decoding every uncached term in one batch."""
        todo = [t for t in dict.fromkeys(terms) if t not in self._doc_cache]
        if todo:
            self._decode_terms(todo, docs=True)
        return {t: self._doc_cache[t] for t in dict.fromkeys(terms)}

    def decode_freqs(self, terms: Sequence[int]) -> Dict[int, np.ndarray]:
        todo = [t for t in dict.fromkeys(terms) if t not in self._freq_cache]
        if todo:
            self._decode_terms(todo, docs=False)
        return {t: self._freq_cache[t] for t in dict.fromkeys(terms)}

    def _decode_terms(self, terms: List[int], docs: bool) -> None:
        idx = self.index
        geo = self._block_geometry(terms)
        multi = idx.kind == "multi"
        # split full-DINT vs partial-interpolative
        dint_rows, part_rows = [], []
        for row in geo:
            (dint_rows if row[3] == BLOCK_SIZE else part_rows).append(row)
        values: Dict[Tuple[int, int], np.ndarray] = {}

        if dint_rows:
            starts, byte_lens, sizes, b_bits, ctxs, bases = [], [], [], [], [], []
            for t, b, pos, size, base in dint_rows:
                s = idx.block_start(b) if docs else int(idx.docs_end[b])
                e = int(idx.docs_end[b]) if docs else int(idx.block_end[b])
                if multi:
                    sc = int(idx.arena[s])
                    ctxs.append(sc % NUM_SELECTORS)
                    b_bits.append(16 if sc < NUM_SELECTORS else 8)
                    s += 1
                else:
                    ctxs.append(0)
                    b_bits.append(16)
                starts.append(s)
                byte_lens.append(e - s)
                sizes.append(size)
                bases.append(base)
            view = self.docs_view if docs else self.freqs_view
            decoded = self._decode_units(
                starts, byte_lens, sizes, view, b_bits, ctxs,
                bases=bases if docs else None,
            )
            for row, vals in zip(dint_rows, decoded):
                values[(row[0], row[1])] = vals

        t0 = time.perf_counter()
        if part_rows:
            # all partial (interpolative) blocks decode as ONE batch
            specs = []
            for t, b, pos, size, base in part_rows:
                if docs:
                    sum_v = int(idx.block_max[b]) - base - (size - 1)
                    specs.append((idx.block_start(b), size, sum_v))
                else:
                    specs.append(
                        (int(idx.docs_end[b]), size, interpolative.UNKNOWN_SUM)
                    )
            decoded_parts = interpolative.decode_blocks_batch(idx.arena, specs)
            for (t, b, pos, size, base), vals in zip(part_rows, decoded_parts):
                values[(t, b)] = vals
        t0 = self._tick("partial", t0)

        # assemble per-term arrays (full DINT doc blocks arrive as
        # device-rebuilt docids; partial blocks rebuild here)
        partial = {(r[0], r[1]) for r in part_rows}
        for t in terms:
            p0, p1 = idx.list_blocks(t)
            parts = []
            for b in range(p0, p1):
                pos = (b - p0) * BLOCK_SIZE
                size = min(BLOCK_SIZE, int(idx.list_n[t]) - pos)
                base = int(idx.block_max[b - 1]) + 1 if b > p0 else 0
                vals = values[(t, b)]
                if docs:
                    if (t, b) in partial:
                        parts.append(
                            np.cumsum(vals.astype(np.int64) + 1) - 1 + base
                        )
                    else:
                        parts.append(vals)  # device docids
                else:
                    parts.append(vals.astype(np.int64) + 1)
            # empty posting lists decode to an empty array
            arr = (
                np.concatenate(parts).astype(np.uint32)
                if parts
                else np.zeros(0, np.uint32)
            )
            if docs:
                self._doc_cache[t] = arr
            else:
                self._freq_cache[t] = arr
        self._tick("assemble", t0)
