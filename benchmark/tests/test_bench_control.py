"""The comparison that decides ``correct`` fails where it must: the
control (the plain reference in the program's place, one precision
down) and each fault a cell can have, planted under the timed path,
with the rest of a run driven as on the card."""

import pytest

from benchmark import control
from benchmark.manifest import Manifest
from benchmark.tests import tiny

SUM_ROWS = 128  # kinds/scan.py's checksum rows


@pytest.fixture
def man(tmp_path):
    return Manifest(tiny.make(str(tmp_path)))


def test_the_control_fails_and_the_program_passes(man):
    rec = control.readings(man, "gov2s-rect.scan", 2**31 + 17, 0.2, "cpu")
    lim = rec["limits"]
    assert all(rec["program"][n] <= lim[n] for n in lim), rec
    assert any(rec["control"][n] > lim[n] for n in rec["control"]), rec


def _stale_run(real):
    """A decode run that returns its first output again (its state left
    unchanged)."""
    def run(self, salt, exact=False):
        if not hasattr(self, "_stale"):
            self._stale = real(self, salt, exact).clone()
        return self._stale
    return run


def _skip_every_other_run(real):
    """Half of the chain's runs skipped: every other run returns the
    output of the run before it without a launch."""
    def run(self, salt, exact=False):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls % 2 == 0:
            return self._last
        self._last = real(self, salt, exact)
        return self._last
    return run


def _half_rows(real):
    """Half of the rows left out: the second half of the output zero."""
    def run(self, salt, exact=False):
        out = real(self, salt, exact).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return run


def _one_int_off(real):
    """One decoded int altered where the launch writes it."""
    def run(self, salt, exact=False):
        out = real(self, salt, exact).clone()
        out[0, 0] += 1
        return out
    return run


@pytest.mark.parametrize("fault", [_stale_run, _skip_every_other_run,
                                   _half_rows, _one_int_off])
def test_a_fault_in_the_decode_launch_reads_incorrect(man, monkeypatch,
                                                      fault):
    from dint_tpu_torch.kernels import decode_local

    real = decode_local._ClassEngine._run
    monkeypatch.setattr(decode_local._ClassEngine, "_run", fault(real))
    out = tiny.run(man, "gov2s-rect.scan")
    assert not out["correct"], out["checks"]


def test_a_launch_that_decodes_only_the_checksummed_rows_reads_incorrect(
        man, monkeypatch):
    """Rows past the first SUM_ROWS of each class left as zero: every
    salt of the chain is right, and the kept run's whole output is
    what fails."""
    from dint_tpu_torch.kernels import decode_local

    real = decode_local._ClassEngine._run

    def run(self, salt, exact=False):
        out = real(self, salt, exact).clone()
        for c in self._classes:
            if c.rows > SUM_ROWS:
                out[c.base + SUM_ROWS:c.base + c.rows] = 0
        return out

    monkeypatch.setattr(decode_local._ClassEngine, "_run", run)
    out = tiny.run(man, "gov2s-rect.scan")
    assert out["checks"]["chain_salts_wrong"]["value"] == 0
    assert out["checks"]["ints_wrong"]["value"] > 0
    assert not out["correct"]


def test_the_window_chains_its_calls_from_the_seed(man, tmp_path):
    """Each call starts at the final salt of the call before, the first
    at a salt drawn from the seed, so no two calls of a run, and no two
    seeds, ask for the same work."""
    import torch

    from benchmark import harness

    cell = man.cell("gov2s-rect.scan")
    tr = man.traffic(cell["traffic"])
    kind = man.kind(tr["kind"])
    firsts = []
    for seed in (2**31 + 5, 2**31 + 6):
        ctx = harness.Context(man.config(cell["config"]), tr, seed,
                              torch.device("cpu"), str(tmp_path))
        st = kind.setup(ctx)
        kind.window(st, 0.5)
        st = kind.release(st)
        finals = [int(x) for x in st["finals"]]
        assert len(set(finals)) == len(finals) >= 2
        assert [int(x) for x in st["replay"]] == finals
        assert all(v == 0 for _, v, _ in kind.check(st))
        firsts.append(st["starts"][0])
    assert firsts[0] != firsts[1]
