"""ds2i binary collection I/O.

File format (reference README.md:41-52,
include/ds2i/binary_collection.hpp:17-30): a flat stream of 32-bit
little-endian unsigned integers; every sequence is prefixed by its
length.  `<basename>.docs` begins with a singleton sequence holding the
number of documents; `<basename>.freqs` has one sequence per posting
list, aligned with the docs file, and no leading singleton.

The reference mmaps the file and iterates sequence by sequence.  Here we
memory-map with numpy and expose both a lazy iterator and a
structure-of-arrays view (offsets + flat values) that batched device
pipelines consume directly.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np


class BinaryCollection:
    """Reader for a length-prefixed u32 sequence file.

    Equivalent surface to the reference's ``binary_collection``
    (binary_collection.hpp:17-146): forward iteration over sequences,
    with empty sequences skipped.
    """

    def __init__(self, path: str):
        self.path = path
        self._data = np.memmap(path, dtype="<u4", mode="r")
        # Precompute sequence boundaries: offsets[i] points at the length
        # word of sequence i. A single sequential pass over the length
        # words only (not the payloads).
        offs: List[int] = []
        lens: List[int] = []
        pos = 0
        n_words = self._data.shape[0]
        while pos < n_words:
            n = int(self._data[pos])
            offs.append(pos)
            lens.append(n)
            pos += 1 + n
        if pos != n_words:
            raise ValueError(f"corrupt collection {path}: trailing words")
        self._offsets = np.asarray(offs, dtype=np.int64)
        self._lengths = np.asarray(lens, dtype=np.int64)

    def __len__(self) -> int:
        return int(self._offsets.shape[0])

    def sequence(self, i: int) -> np.ndarray:
        off = self._offsets[i]
        n = self._lengths[i]
        return np.asarray(self._data[off + 1 : off + 1 + n])

    def __iter__(self) -> Iterator[np.ndarray]:
        # Skips empty sequences, like the reference iterator
        # (binary_collection.hpp:131-146).
        for i in range(len(self)):
            if self._lengths[i] > 0:
                yield self.sequence(i)

    @property
    def lengths(self) -> np.ndarray:
        return self._lengths

    def num_postings(self) -> int:
        return int(self._lengths.sum())

    def flat_view(self):
        """(values, offsets, lengths): SoA view for batched processing.

        ``values`` is the raw word stream (including length words);
        sequence i's payload is ``values[offsets[i]+1 : offsets[i]+1+lengths[i]]``.
        """
        return self._data, self._offsets, self._lengths


@dataclass
class FreqCollectionView:
    """Zipped docs+freqs view (reference binary_freq_collection.hpp:14-23)."""

    num_docs: int
    docs: BinaryCollection
    freqs: BinaryCollection

    def __len__(self) -> int:
        return len(self.freqs)

    def __iter__(self):
        # docs has the leading singleton; skip it.
        di = iter(range(1, len(self.docs)))
        fi = iter(range(0, len(self.freqs)))
        for d, f in zip(di, fi):
            yield self.docs.sequence(d), self.freqs.sequence(f)


def open_freq_collection(basename: str) -> FreqCollectionView:
    docs = BinaryCollection(basename + ".docs")
    freqs = BinaryCollection(basename + ".freqs")
    if len(docs) == 0 or docs.lengths[0] != 1:
        raise ValueError("docs file must start with a num-docs singleton")
    num_docs = int(docs.sequence(0)[0])
    if len(docs) - 1 != len(freqs):
        raise ValueError("docs/freqs sequence count mismatch")
    return FreqCollectionView(num_docs, docs, freqs)


def write_binary_collection(path: str, sequences: Sequence[np.ndarray]) -> None:
    """Write sequences in the ds2i length-prefixed format."""
    with open(path, "wb") as f:
        for seq in sequences:
            seq = np.asarray(seq, dtype="<u4")
            np.asarray([seq.shape[0]], dtype="<u4").tofile(f)
            seq.tofile(f)


def write_freq_collection(
    basename: str,
    doc_lists: Sequence[np.ndarray],
    freq_lists: Sequence[np.ndarray],
    num_docs: int,
) -> None:
    write_binary_collection(
        basename + ".docs",
        [np.asarray([num_docs], dtype="<u4")] + list(doc_lists),
    )
    write_binary_collection(basename + ".freqs", list(freq_lists))


def write_sizes_file(basename: str, doc_sizes: np.ndarray) -> None:
    """`.sizes`: one sequence holding per-document lengths (wand input)."""
    write_binary_collection(basename + ".sizes", [np.asarray(doc_sizes)])


def read_sizes_file(basename: str) -> np.ndarray:
    c = BinaryCollection(basename + ".sizes")
    return c.sequence(0).astype(np.uint32)


class BinaryBlocksCollection:
    """(freq, data) block file reader/writer
    (binary_blocks_collection.hpp: u32 num_blocks header, then per block
    u32 size, u32 freq, size u32 values — the offline dictionary-tooling
    interchange format)."""

    def __init__(self, path: str):
        self._data = np.memmap(path, dtype="<u4", mode="r")
        self.num_blocks = int(self._data[0])

    def __iter__(self):
        pos = 1
        for _ in range(self.num_blocks):
            size = int(self._data[pos])
            freq = int(self._data[pos + 1])
            yield freq, np.asarray(self._data[pos + 2 : pos + 2 + size])
            pos += 2 + size

    @staticmethod
    def write(path: str, blocks) -> None:
        """blocks: iterable of (freq, values)."""
        blocks = list(blocks)
        with open(path, "wb") as f:
            np.asarray([len(blocks)], dtype="<u4").tofile(f)
            for freq, vals in blocks:
                vals = np.asarray(vals, dtype="<u4")
                np.asarray([vals.shape[0], freq], dtype="<u4").tofile(f)
                vals.tofile(f)
