"""Spans at the port's layer boundaries: the index build, the host plan
and device load, the library builds, and the decode launch's host side.

``with trace.span("load.plan"): ...`` times its body on the host clock
and adds to a process-wide table of ``count``, total time and self time
(the time less that of the spans opened inside it on the same thread).
The spans are always on and cost two clock reads and a few adds.

While a torch profiler records, a span opens
``torch.profiler.record_function("dint." + name)`` instead and adds
nothing to the table: the range lands in the profiler's trace on the
same clock as the card's kernels, and the table keeps untraced work
only.  Outside a profiler no profiler range is opened: an idle
``record_function`` costs several times the span itself.

``snapshot()`` reads the table, ``reset()`` clears it.  Nothing is
written anywhere: the table lives in memory for as long as the process.
"""

from __future__ import annotations

import sys
import threading
from time import perf_counter_ns
from typing import Dict

PREFIX = "dint."


def _profiling() -> bool:
    """Whether a torch profiler records.  Torch is not imported here: the
    native builds and the zoo's encode workers run without it, and no
    torch profiler records before torch is loaded.  Once it is, the
    check is torch's own flag."""
    global _profiling
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _profiling = torch._C._autograd._profiler_enabled
    return _profiling()

_local = threading.local()
_lock = threading.Lock()
_tables = []  # one {name: [count, total_ns, self_ns]} a thread


def _new_thread_state():
    st = _local.state = ([], {})  # (open spans, table)
    with _lock:
        _tables.append(st[1])
    return st


class span:
    """A context manager timing its body as the span ``name``."""

    __slots__ = ("name", "t0", "inner_ns", "_range", "_state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            import torch.profiler

            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
            return self
        self._range = None
        try:
            st = _local.state
        except AttributeError:
            st = _new_thread_state()
        st[0].append(self)
        self._state = st
        self.inner_ns = 0
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            return False
        dt = perf_counter_ns() - self.t0
        stack, table = self._state
        stack.pop()
        if stack:
            stack[-1].inner_ns += dt
        e = table.get(self.name)
        if e is None:
            e = table[self.name] = [0, 0, 0]
        e[0] += 1
        e[1] += dt
        e[2] += dt - self.inner_ns
        return False


def snapshot() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "total_s", "self_s"}}`` of every span closed
    outside a profiler since the start or the last ``reset``, summed
    over threads."""
    acc = {}
    with _lock:
        tables = list(_tables)
    for t in tables:
        for name, (n, total, own) in list(t.items()):
            a = acc.setdefault(name, [0, 0, 0])
            a[0] += n
            a[1] += total
            a[2] += own
    return {name: {"count": n, "total_s": total * 1e-9, "self_s": own * 1e-9}
            for name, (n, total, own) in acc.items()}


def reset() -> None:
    """Clear the table of every thread."""
    with _lock:
        for t in _tables:
            t.clear()
