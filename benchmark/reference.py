"""The plain reference: what the program's answers are judged against.

Plain numpy over the benchmark's own collection (``collection.py``); it
imports neither ``jax``, the JAX package, nor anything of
``dint_tpu_torch``, and takes nothing the program made.

* ``docid_gaps``: every list's d-gaps, ``doc[i] - doc[i-1] - 1`` with
  the first gap ``doc[0]`` (the reference encoder's gap transform), list
  after list, as one flat u32 array.
* ``narrowed_gaps``: the control, the same gaps one precision down.
"""

from __future__ import annotations

import numpy as np


def docid_gaps(docs: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """The gaps of the lists that start at ``starts`` in ``docs`` (every
    list non-empty)."""
    d = docs.astype(np.int64)
    g = np.empty_like(d)
    g[1:] = d[1:] - d[:-1] - 1
    g[starts] = d[starts]
    return g.astype(np.uint32)


def narrowed_gaps(gaps: np.ndarray, bits: int = 16) -> np.ndarray:
    """The control of the decode: the reference's gaps carried in
    ``bits``-bit ints, the narrower type a decoder could be tempted to
    write (u16 for the u32 the configuration states)."""
    return (gaps & ((1 << bits) - 1)).astype(np.uint32)
