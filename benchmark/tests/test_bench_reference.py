"""The benchmark's collection and plain reference, held to the program
(``dint_tpu_torch``) at a tiny size on the CPU."""

import numpy as np
import pytest

from benchmark import collection, reference
from benchmark.manifest import Manifest
from benchmark.tests import tiny

SHAPE = dict(tiny.TINY_COLLECTION)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_a_seed_gives_the_same_collection_and_every_seed_the_same_sizes(
        seed):
    a = collection.make(SHAPE, seed)
    b = collection.make(SHAPE, seed)
    assert np.array_equal(a.docs, b.docs)
    assert np.array_equal(a.lengths, b.lengths)
    other = collection.make(SHAPE, seed + 1)
    assert np.array_equal(np.sort(a.lengths), np.sort(other.lengths))
    assert a.postings == SHAPE["num_postings"] == a.docs.shape[0]
    assert a.lengths.shape[0] == SHAPE["num_lists"]
    ends = a.starts + a.lengths
    for s, e in zip(a.starts, ends):
        d = a.docs[s:e].astype(np.int64)
        assert (np.diff(d) > 0).all() and 0 <= d[0] and d[-1] < SHAPE[
            "num_docs"]
    assert int(a.lengths.max()) >= 0.99 * SHAPE["num_docs"]


def test_the_written_file_reads_back_through_the_program(tmp_path):
    from dint_tpu_torch.io.collection import BinaryCollection
    from dint_tpu_torch.tools.common import gap_lists_of

    coll = collection.make(SHAPE, 3)
    base = str(tmp_path / "c")
    collection.write(base, coll)
    head, *lists = list(BinaryCollection(base + ".docs"))
    assert list(head) == [coll.num_docs]
    assert len(lists) == coll.lengths.shape[0]
    for d, s, n in zip(lists, coll.starts, coll.lengths):
        assert np.array_equal(d, coll.docs[s:s + n])
    gaps, _ = gap_lists_of(base + ".docs")
    assert np.array_equal(np.concatenate(gaps),
                          reference.docid_gaps(coll.docs, coll.starts))


def test_the_controls_precision_is_what_it_claims():
    g = np.asarray([0, 1, 65535, 65536, 70000, 2**31], np.uint32)
    assert np.array_equal(reference.narrowed_gaps(g),
                          np.asarray([0, 1, 65535, 0, 4464, 0], np.uint32))
    coll = collection.make(SHAPE, 4)
    want = reference.docid_gaps(coll.docs, coll.starts)
    assert np.count_nonzero(reference.narrowed_gaps(want) != want) > 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_on_the_cpu_is_correct(tmp_path, trace):
    out = tiny.run(Manifest(tiny.make(str(tmp_path))), "gov2s-rect.scan",
                   trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
