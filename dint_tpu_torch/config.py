"""DINT configuration constants.

Mirrors the semantics of the reference configuration
(include/dint/dint_configuration.hpp:20-28 and
include/ds2i/util.hpp:31-39): b=16 codeword bits,
max entry size l=16, 2^16 dictionary entries, target sub-block sizes
{16,8,4,2,1}, 6 selector contexts, 2 reserved exception codewords and
5 reserved run codewords, 256-integer posting blocks.

These are module-level constants (the reference bakes them in at compile
time); everything downstream treats them as static, so the device
arrays have fixed shapes.
"""

from __future__ import annotations

import dataclasses

# Number of reserved exception codewords: index 0 = 2-byte exception,
# index 1 = 4-byte exception (reference dint_configuration.hpp:6).
EXCEPTIONS = 2

# Run codewords occupy indices EXCEPTIONS..EXCEPTIONS+4 and decode to runs
# of 256/128/64/32/16 zeros (reference single_dictionary.hpp:43-56).
NUM_RUNS = 5
RUN_LENGTHS = (256, 128, 64, 32, 16)

# Total reserved codewords at the head of every dictionary.
RESERVED = EXCEPTIONS + NUM_RUNS  # == 7

# Dictionary geometry (b = 16, l = 16).
MAX_ENTRY_SIZE = 16
TARGET_SIZES = (16, 8, 4, 2, 1)
NUM_TARGET_SIZES = len(TARGET_SIZES)
NUM_ENTRIES = 65536
LOG2_NUM_ENTRIES = 16

# Multi-dictionary selector contexts. The selector of a 256-int block is
# ceil_log2(ceil_log2(max+1)) of the block max, clamped to [0, 5]
# (reference statistics_collectors.hpp:21-40).
NUM_SELECTORS = 6

# Posting-list blocking (reference util.hpp:33-35).
BLOCK_SIZE = 256
MIN_SIZE = 0          # lists shorter than this are skipped in stats
MAX_SIZE = 50_000_000  # decode scratch upper bound

# Exceptions: values < 2^16 use the 2-byte form, else the 4-byte form
# (reference include/dint/dint_codecs.hpp:107-118).
SMALL_EXCEPTION_LIMIT = 1 << 16

# DSF dictionary-building cost model
# (reference dictionary_builders.hpp:15-26): an integer not in the
# dictionary is assumed to cost initial_bpi bits; a dictionary hit costs
# codeword_bits for the whole entry.
CODEWORD_BITS = 16.0
INITIAL_BPI = 3 * CODEWORD_BITS
EPS = 0.0001
# DSF uses filter threshold eps/1000 (dictionary_builders.hpp:50-53).
DSF_FILTER_THRESHOLD = EPS / 1000.0


@dataclasses.dataclass(frozen=True)
class DintParams:
    """Bundle of the compile-time constants, for APIs that want a handle."""

    exceptions: int = EXCEPTIONS
    reserved: int = RESERVED
    max_entry_size: int = MAX_ENTRY_SIZE
    num_entries: int = NUM_ENTRIES
    num_selectors: int = NUM_SELECTORS
    block_size: int = BLOCK_SIZE
    target_sizes: tuple = TARGET_SIZES


DEFAULT_PARAMS = DintParams()
