"""The whole slice: encode, plan, decode and check, port against reference.

The port encodes a small collection that drives all three width classes,
then ``decode_stream(..., device="cpu")`` decodes it through the serving
image and the kernels' plain twins and checks every list against the
collection.  Its stats record carries the reference's keys plus
``"device"``, and its per-list output equals the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from dint_tpu.index import stream as j_stream
from dint_tpu.tools import decode as j_decode
from dint_tpu_torch.index import stream as t_stream
from dint_tpu_torch.tools import decode as t_decode
from tests.test_torch_host_copies import encode_both, write_mixed_collection

TYPES = ("single_rect_dint", "multi_packed_dint")


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """{type: {pkg: (stream, dict file)}}, the collection basename and
    its gap lists."""
    root = str(tmp_path_factory.mktemp("torch_stream"))
    base = os.path.join(root, "mixed")
    gaps = write_mixed_collection(base, seed=9)
    enc = {t: encode_both(os.path.join(root, t), base, t) for t in TYPES}
    return enc, base, gaps


@pytest.mark.parametrize("type_name", TYPES)
def test_decode_stream_checks_and_keeps_the_record(encoded, type_name,
                                                   capsys):
    enc, base, _ = encoded
    jstream, jdict = enc[type_name]["jax"]
    tstream, tdict = enc[type_name]["torch"]
    jrec = j_decode.decode_stream(type_name, jstream, jdict, runs=1,
                                  check_collection=base + ".docs")
    trec = t_decode.decode_stream(type_name, tstream, tdict, runs=2,
                                  check_collection=base + ".docs",
                                  device="cpu")
    assert trec["check"] == "ok" == jrec["check"]
    assert set(trec) == set(jrec) | {"device"}
    assert trec["device"] == "cpu"
    for k in ("num_sequences", "num_integers", "type", "engine",
              "plan_bytes", "rows", "geometry"):
        assert trec[k] == jrec[k], k
    # the stats line on stdout is the record
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert json.loads(lines[-1]) == trec


@pytest.mark.parametrize("type_name", TYPES)
def test_gather_lists_equal_reference(encoded, type_name):
    enc, _, gaps = encoded
    stream, dict_file = enc[type_name]["torch"]
    multi = type_name.startswith("multi")
    ja, jm = j_stream.load_stream(stream)
    jv = j_decode.load_dictionary(type_name, dict_file).decode_view()
    jlists = j_decode.StreamDecoder(ja, jm, jv, multi).gather_lists()
    ta, tm = t_stream.load_stream(stream)
    tv = t_decode.load_dictionary(type_name, dict_file).decode_view()
    dec = t_decode.StreamDecoder(ta, tm, tv, multi, device="cpu")
    tlists = dec.gather_lists()
    assert len(tlists) == len(jlists) == len(gaps)
    for g, j, t in zip(gaps, jlists, tlists):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, g)
    elapsed, total = dec.timed_runs(2)
    assert total == sum(g.shape[0] for g in gaps) and elapsed > 0
    assert isinstance(dec.final_salt, int)


def test_cli_main_prints_the_record(encoded, capsys):
    enc, base, _ = encoded
    stream, dict_file = enc["single_rect_dint"]["torch"]
    t_decode.main(["single_rect_dint", stream, "--dict", dict_file,
                   "--runs", "1", "--check-collection", base + ".docs",
                   "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["check"] == "ok" and rec["device"] == "cpu"
    assert rec["runs"] == "1" and rec["engine"] == "local"


@pytest.mark.parametrize("engine", ["raw"])
def test_unported_engines_name_their_roadmap_item(encoded, engine):
    enc, _, _ = encoded
    stream, dict_file = enc["single_rect_dint"]["torch"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_decode.decode_stream("single_rect_dint", stream, dict_file,
                               runs=1, engine=engine, device="cpu")


@pytest.mark.parametrize("type_name", TYPES)
def test_ladder_engine_decodes_the_mixed_collection(encoded, type_name):
    """engine='ladder' (ported since) on the three-class collection:
    exact, and its record has no image geometry, as in the reference."""
    enc, base, _ = encoded
    stream, dict_file = enc[type_name]["torch"]
    jrec = j_decode.decode_stream(type_name, stream, dict_file, runs=1,
                                  check_collection=base + ".docs",
                                  engine="ladder")
    trec = t_decode.decode_stream(type_name, stream, dict_file, runs=1,
                                  check_collection=base + ".docs",
                                  engine="ladder", device="cpu")
    assert trec["check"] == "ok" == jrec["check"]
    assert set(trec) == set(jrec) | {"device"}
    assert trec["plan_bytes"] == jrec["plan_bytes"]
    assert trec["num_integers"] == jrec["num_integers"]


def test_default_device_raises_without_cuda(encoded, monkeypatch):
    enc, _, _ = encoded
    stream, dict_file = enc["single_rect_dint"]["torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_decode.decode_stream("single_rect_dint", stream, dict_file, runs=1)
