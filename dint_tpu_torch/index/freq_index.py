"""Elias-Fano-family frequency indexes (ef / single / uniform / opt).

Rebuild of freq_index<DocsSequence, FreqsSequence> (freq_index.hpp) and
its four instantiations (index_types.hpp:25-37):

  ef      = freq_index<compact_elias_fano, positive_sequence<strict_elias_fano>>
  single  = freq_index<indexed_sequence,   positive_sequence<strict_sequence>>
  uniform = freq_index<uniform_partitioned<indexed>, positive<uniform_partitioned<strict>>>
  opt     = freq_index<partitioned<indexed>,          positive<partitioned<strict>>>   (PEF)

Per-list layout matches freq_index.hpp:59-70: gamma_nonzero(occurrences)
[+ n in ceil_log2(occurrences+1) bits when occurrences > 1], then the
docs sequence over universe num_docs, with the freqs sequence (over
universe occurrences+1) in a parallel bitvector collection; both
collections use EF endpoint directories (bitvector_collection.hpp).
Readers decode whole lists (the batched-query access pattern) instead
of pointer-walking enumerators.

Host copy of ``dint_tpu/index/freq_index.py``; ``EFTermDecoder`` takes
``device`` and ``device_ef`` where the reference reads
``DINT_TPU_DEVICE_EF``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..backend import resolve_device
from ..codecs import ef
from ..io.collection import open_freq_collection
from ..utils import bitio
from ..utils.bitio import BitBuilder, BitReader, ceil_log2


def _sequences(kind: str):
    if kind == "ef":
        return ef.compact_elias_fano, ef.positive_sequence(ef.strict_elias_fano)
    if kind == "single":
        return ef.indexed_sequence, ef.positive_sequence(ef.strict_sequence)
    if kind == "uniform":
        return (
            ef.uniform_partitioned_sequence(ef.indexed_sequence),
            ef.positive_sequence(
                ef.uniform_partitioned_sequence(ef.strict_sequence)
            ),
        )
    if kind == "opt":
        return (
            ef.partitioned_sequence(ef.indexed_sequence),
            ef.positive_sequence(ef.partitioned_sequence(ef.strict_sequence)),
        )
    raise ValueError(kind)


@dataclass
class BitvectorCollection:
    """Concatenated bit sequences + EF endpoint directory
    (bitvector_collection.hpp:15-67)."""

    words: np.ndarray
    total_bits: int
    endpoints: np.ndarray  # decoded endpoints (L+1 not stored; L entries)

    def endpoint_bits(self, params) -> int:
        L = self.endpoints.shape[0]
        if L == 0:
            return 0
        return ef.compact_elias_fano.bitsize(params, max(self.total_bits, 1), L)


class FreqIndexEF:
    """The loaded index."""

    def __init__(self, kind: str, num_docs: int, docs: BitvectorCollection,
                 freqs: BitvectorCollection, params=None):
        self.kind = kind
        self.num_docs = num_docs
        self.docs = docs
        self.freqs = freqs
        self.params = params or ef.PARAMS

    @property
    def num_lists(self) -> int:
        return int(self.docs.endpoints.shape[0])

    # `num_lists` alias used by the shared query tooling
    def __len__(self) -> int:
        return self.num_lists

    def _list_header(self, i: int) -> Tuple[int, int, int]:
        """(occurrences, n, docs_seq_bit_offset)."""
        off = int(self.docs.endpoints[i])
        r = BitReader(self.docs.words, off)
        occurrences = ef.read_gamma(r) + 1
        if occurrences > 1:
            n = r.take(ceil_log2(occurrences + 1))
        else:
            n = 1
        return occurrences, n, r.pos

    def list_docids(self, i: int) -> np.ndarray:
        docs_seq, _ = _sequences(self.kind)
        occurrences, n, pos = self._list_header(i)
        return docs_seq.decode_all(
            self.docs.words, pos, self.num_docs, n, self.params
        ).astype(np.uint32)

    def list_freqs(self, i: int) -> np.ndarray:
        _, freqs_seq = _sequences(self.kind)
        occurrences, n, _ = self._list_header(i)
        off = int(self.freqs.endpoints[i])
        return freqs_seq.decode_all(
            self.freqs.words, off, occurrences + 1, n, self.params
        ).astype(np.uint32)

    @property
    def list_n(self) -> np.ndarray:
        if not hasattr(self, "_list_n"):
            self._list_n = np.asarray(
                [self._list_header(i)[1] for i in range(self.num_lists)],
                dtype=np.uint32,
            )
        return self._list_n

    def size_stats(self) -> dict:
        postings = 0
        for i in range(self.num_lists):
            _, n, _ = self._list_header(i)
            postings += n
        p = self.params
        docs_bits = self.docs.total_bits + self.docs.endpoint_bits(p)
        freq_bits = self.freqs.total_bits + self.freqs.endpoint_bits(p)
        return {
            "postings": postings,
            "docs_bpi": docs_bits / max(postings, 1),
            "freqs_bpi": freq_bits / max(postings, 1),
        }

    def save(self, path: str) -> None:
        np.savez(
            path,
            kind=np.frombuffer(self.kind.encode(), dtype=np.uint8),
            num_docs=np.asarray([self.num_docs], np.uint64),
            docs_words=self.docs.words,
            docs_bits=np.asarray([self.docs.total_bits], np.uint64),
            docs_endpoints=self.docs.endpoints,
            freqs_words=self.freqs.words,
            freqs_bits=np.asarray([self.freqs.total_bits], np.uint64),
            freqs_endpoints=self.freqs.endpoints,
        )

    @classmethod
    def load(cls, path: str) -> "FreqIndexEF":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(
            z["kind"].tobytes().decode(),
            int(z["num_docs"][0]),
            BitvectorCollection(
                z["docs_words"], int(z["docs_bits"][0]), z["docs_endpoints"]
            ),
            BitvectorCollection(
                z["freqs_words"], int(z["freqs_bits"][0]), z["freqs_endpoints"]
            ),
        )


def build_freq_index(basename: str, kind: str = "opt") -> FreqIndexEF:
    """create_freq_index path for the EF family
    (freq_index.hpp:25-90 build semantics)."""
    params = ef.PARAMS
    view = open_freq_collection(basename)
    docs_seq, freqs_seq = _sequences(kind)
    docs_bb = BitBuilder()
    freqs_bb = BitBuilder()
    docs_eps: List[int] = []
    freqs_eps: List[int] = []
    for docs, freqs in view:
        n = int(docs.shape[0])
        occurrences = int(freqs.astype(np.int64).sum())
        docs_eps.append(docs_bb.size)
        freqs_eps.append(freqs_bb.size)
        ef.write_gamma_nonzero(docs_bb, occurrences)
        if occurrences > 1:
            docs_bb.append_bits(n, ceil_log2(occurrences + 1))
        docs_seq.write(docs_bb, docs, view.num_docs, n, params)
        freqs_seq.write(freqs_bb, freqs, occurrences + 1, n, params)
    return FreqIndexEF(
        kind,
        view.num_docs,
        BitvectorCollection(
            docs_bb.words(), docs_bb.size, np.asarray(docs_eps, np.uint64)
        ),
        BitvectorCollection(
            freqs_bb.words(), freqs_bb.size, np.asarray(freqs_eps, np.uint64)
        ),
    )


class EFListCursor:
    """document_enumerator for the EF-family indexes: docids skip via
    the sequence enumerators' sampled pointers (codecs/ef_enum.py), and
    freqs read positionally from the positive/strict sequence — the
    freq_index.hpp:101-163 access pattern (freq = freqs.move(pos+1) -
    freqs.move(pos))."""

    __slots__ = ("cache", "term", "n", "num_docs", "_docs_e", "_freqs_e",
                 "_occ")

    def __init__(self, cache: "EFLazyCache", term: int):
        from ..codecs import ef_enum

        self.cache = cache
        idx = cache.index
        self.term = term
        occurrences, n, pos = idx._list_header(term)
        self.n = n
        self._occ = occurrences
        self.num_docs = idx.num_docs
        if idx.kind == "ef":
            self._docs_e = ef_enum.EFEnumerator(
                idx.docs.words, pos, idx.num_docs, n, idx.params
            )
        elif idx.kind == "single":
            self._docs_e = ef_enum.indexed_enumerator(
                idx.docs.words, pos, idx.num_docs, n, idx.params
            )
        else:  # 'uniform' / 'opt' (PEF): partition-directory skipping
            self._docs_e = ef_enum.PartitionedEnumerator(
                idx.docs.words, pos, idx.num_docs, n, idx.params,
                base="indexed", uniform=(idx.kind == "uniform"),
            )
        self._freqs_e = None
        if n:
            self._docs_e.move(0)
        self.cache.moves += 1

    @property
    def size(self) -> int:
        return self.n

    def docid(self) -> int:
        if self.n == 0:
            return self.num_docs
        v = self._docs_e.value()
        return self.num_docs if self._docs_e.position() >= self.n else int(v)

    def position(self) -> int:
        return self._docs_e.position()

    def freq(self) -> int:
        from ..codecs import ef_enum

        if self._freqs_e is None:
            idx = self.cache.index
            off = int(idx.freqs.endpoints[self.term])
            if idx.kind == "ef":
                self._freqs_e = ef_enum.StrictEFEnumerator(
                    idx.freqs.words, off, self._occ + 1, self.n, idx.params
                )
            elif idx.kind == "single":
                self._freqs_e = ef_enum.StrictSeqEnumerator(
                    idx.freqs.words, off, self._occ + 1, self.n, idx.params
                )
            else:
                self._freqs_e = ef_enum.PartitionedEnumerator(
                    idx.freqs.words, off, self._occ + 1, self.n, idx.params,
                    base="strict", uniform=(idx.kind == "uniform"),
                )
            self.cache.freq_lists_opened += 1
        k = self._docs_e.position()
        # forward order (k-1 then k): both are cheap forward steps from
        # the enumerator's cached state; the reverse order forces a
        # sample-directory reposition on every freq read
        s0 = self._freqs_e.move(k - 1) if k else 0
        s1 = self._freqs_e.move(k)
        return int(s1 - s0)

    def next(self) -> None:
        self._docs_e.next()
        self.cache.moves += 1

    def next_geq(self, target: int) -> None:
        self._docs_e.next_geq(target)
        self.cache.moves += 1


class EFLazyCache:
    """Counter-carrying cursor factory for the EF-family indexes (the
    lazy_cache protocol ranked.wand/maxscore consume)."""

    def __init__(self, index: FreqIndexEF):
        self.index = index
        self.postings_scored = 0
        self.moves = 0
        self.freq_lists_opened = 0
        # the shared wand/AND helpers read block counters; EF indexes
        # have no blocks — report enumerator moves instead
        self.docs_blocks_decoded = 0
        self.freqs_blocks_decoded = 0

    def make_cursor(self, term: int) -> EFListCursor:
        return EFListCursor(self, int(term))


class EFTermDecoder:
    """TermDecoder-compatible reader for the EF-family indexes: decodes
    whole posting lists with caching (the batched query access path).

    With ``device_ef=True`` and the plain-EF kind, uncached docid lists
    decode on ``device`` in one flat pass (``codecs/ef_device.py``:
    gathers for the low fields, popcount ranks for select_1); otherwise
    on the host.  ``device_ef`` defaults to False, as the reference's
    opt-in does.  ``device`` is also where the serving engines put what
    this decoder decodes."""

    def __init__(self, index: FreqIndexEF, device="cuda",
                 device_ef: bool = False):
        self.index = index
        self.device = resolve_device(device)
        self._doc_cache = {}
        self._freq_cache = {}
        self._lazy_cache = None
        self.device_ef = bool(device_ef) and index.kind == "ef"

    @property
    def lazy_cache(self):
        """Skipping-cursor factory: all four EF-family kinds have
        enumerators (compact EF / indexed dispatch / partitioned with
        upper-bound directory skips)."""
        if self._lazy_cache is None:
            self._lazy_cache = EFLazyCache(self.index)
        return self._lazy_cache

    def decode_docids(self, terms):
        todo = [
            int(t) for t in dict.fromkeys(terms) if t not in self._doc_cache
        ]
        if todo and self.device_ef:
            from ..codecs import ef_device

            idx = self.index
            specs = []
            for t in todo:
                _, n, pos = idx._list_header(t)
                specs.append((pos, idx.num_docs, n))
            for t, vals in zip(
                todo, ef_device.decode_lists(idx.docs.words, specs,
                                             idx.params, self.device)
            ):
                self._doc_cache[t] = vals.astype(np.uint32)
        else:
            for t in todo:
                self._doc_cache[t] = self.index.list_docids(t)
        return {t: self._doc_cache[t] for t in dict.fromkeys(terms)}

    def decode_freqs(self, terms):
        for t in dict.fromkeys(terms):
            if t not in self._freq_cache:
                self._freq_cache[t] = self.index.list_freqs(int(t))
        return {t: self._freq_cache[t] for t in dict.fromkeys(terms)}


def verify_freq_index(index: FreqIndexEF, basename: str) -> None:
    view = open_freq_collection(basename)
    for i, (docs, freqs) in enumerate(view):
        got_d = index.list_docids(i)
        got_f = index.list_freqs(i)
        if not np.array_equal(got_d, docs):
            raise SystemExit(f"docid mismatch in list {i} (kind={index.kind})")
        if not np.array_equal(got_f, freqs):
            raise SystemExit(f"freq mismatch in list {i} (kind={index.kind})")


class SequenceCollection:
    """Standalone collection of indexed_sequences
    (sequence_collection.hpp — a test/bench utility container)."""

    def __init__(self):
        self._bb = BitBuilder()
        self._meta = []  # (offset, universe, n)

    def append(self, values, universe: int) -> None:
        values = np.asarray(values, dtype=np.uint64)
        self._meta.append((self._bb.size, universe, values.shape[0]))
        ef.indexed_sequence.write(self._bb, values, universe, values.shape[0], ef.PARAMS)

    def __len__(self):
        return len(self._meta)

    def get(self, i: int) -> np.ndarray:
        off, universe, n = self._meta[i]
        return ef.indexed_sequence.decode_all(self._bb.words(), off, universe, n, ef.PARAMS)
