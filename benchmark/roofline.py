"""Peaks of the card and the bytes a decode must move.

The published device-memory rates of the H100 parts (NVIDIA's data
sheets; the same table as ``dint_tpu_torch/tools/scale_test.py``'s
``HBM_BYTES_PER_S``), and the byte count behind ``decode_roofline``:
what a whole-index decode has to move whatever implements it, taken
from the files and counts the benchmark made, never from the port's
image or launch tables.
"""

from __future__ import annotations

import os

HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12))


def hbm_rate(device_kind: str):
    """Bytes a second of the card named ``device_kind``; None for a card
    not in the table (the metric is then left out, never 0)."""
    for key, rate in HBM_BYTES_PER_S:
        if key in device_kind:
            return rate
    return None


def decode_bytes(stream_file: str, dict_file: str, ints: int) -> int:
    """One whole decode: the encoded stream as stored, read once; the
    dictionary as stored, read once; 4 B written for each int."""
    return (os.path.getsize(stream_file) + os.path.getsize(dict_file)
            + 4 * int(ints))
