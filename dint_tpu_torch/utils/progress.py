"""Build-time progress reporting.

The reference shows boost::progress_display bars during statistics
collection (block_statistics.hpp:52) and a docs/postings
`progress_logger` during index build (index_build_utils.hpp:70-89).
Here: a lightweight counter that logs rate + ETA to stderr at a bounded
frequency (long builds stay observable without drowning the log).
"""

from __future__ import annotations

import sys
import time


class ProgressLogger:
    def __init__(self, total: int | None, label: str, every_s: float = 5.0):
        self.total = total
        self.label = label
        self.every_s = every_s
        self.count = 0
        self.t0 = time.perf_counter()
        self._last = self.t0

    def add(self, n: int = 1) -> None:
        self.count += n
        now = time.perf_counter()
        if now - self._last >= self.every_s:
            self._last = now
            self._emit(now)

    def _emit(self, now: float) -> None:
        dt = max(now - self.t0, 1e-9)
        rate = self.count / dt
        if self.total:
            pct = 100.0 * self.count / self.total
            eta = (self.total - self.count) / max(rate, 1e-9)
            msg = (f"{self.label}: {self.count}/{self.total} "
                   f"({pct:.1f}%), {rate:.0f}/s, ETA {eta:.0f}s")
        else:
            msg = f"{self.label}: {self.count}, {rate:.0f}/s"
        print(msg, file=sys.stderr, flush=True)

    def done(self) -> None:
        self._emit(time.perf_counter())
