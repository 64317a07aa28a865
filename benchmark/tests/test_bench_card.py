"""Tests that need an NVIDIA card: each is marked ``cuda`` and skips
itself where ``torch.cuda.is_available()`` is False.  On the card:

    python3 -m pytest -q benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.manifest import ROOT, Manifest

MAN = Manifest()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in MAN.data["workloads"]])
def test_a_short_run_of_each_cell_is_correct_on_the_card(cell):
    _card()
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in MAN.per_layer(cell)}
