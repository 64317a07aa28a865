"""Spans and counters the benchmark records around its calls into the
program's layers.

A span is timed on the host clock and also opened as a profiler range
(``bench.<name>``), so that a traced run can name each device idle gap
by the span that was open on the host.  Totals and counts are kept in
memory and read by the per-layer metrics when the run ends.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

PREFIX = "bench."


class Spans:
    def __init__(self):
        self.total = defaultdict(float)  # seconds a span name
        self.count = defaultdict(int)
        self.counters = defaultdict(int)

    @contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1

    def add(self, counter: str, n: int) -> None:
        self.counters[counter] += int(n)

    def snapshot(self) -> "Spans":
        """A copy of the totals, counts and counters as they stand."""
        s = Spans()
        s.total.update(self.total)
        s.count.update(self.count)
        s.counters.update(self.counters)
        return s
