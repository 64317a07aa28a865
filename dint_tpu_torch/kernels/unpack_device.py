"""Device bit-unpack engines for the ladder image and the zoo's wire
formats on the engine's device (the reference package's
``kernels/unpack_device.py``, whose per-class unpacks are XLA ops).

The ladder image is codec-independent: at LOAD time the stream is
host-decoded once, the flat value stream is cut into 256-value blocks,
and each block is re-packed at the smallest no-straddle ladder width
(``_LADDER``) that holds its values, so every value lives whole inside
one u32 word.  Blocks of one width form a class, stored lane-major
((W, M, 128) u32 words: word k of class row i at [k, i // 128, i % 128]).
At DECODE time each class is one broadcast shift and mask over its
words (``_fns``), with the block minimum added back for base-relative
classes (``_fns_base``).  The trailing partial block stays on the host
as plan values.  ``plan_ladder`` builds this image for any zoo codec.
On the card every ladder class of a run (``pfor`` and ``pforb``) decodes
in ONE launch of X1, the hand kernel ``csrc/ladder_unpack.cu``
(``ladder_unpack`` over the engine's ``LadderClasses``); ``_fns`` and
``_fns_base`` are its plain version, which the CPU runs.  X1's second
entry, ``ladder_rows``, decodes the sharded step's row-major classes.

The wire-format engines keep a codec's own structure on the device:
``plan_optpfor`` (blocks by bit width; the engine folds the exceptions
into the values at load and re-packs them at ladder widths),
``plan_qmx`` (one class row per QMX instance, unpacked by the width's
static row shifts, ``_qmx_fns``, torch ops), ``plan_simple16`` (one class per
selector mode, ``Simple16Engine``) and ``plan_byteclass`` (every value's
bytes in the dense array of its byte length, ``ByteClassEngine``).  On
the card the byte engine's classes decode in ONE launch of X4, the hand
kernel ``csrc/byteclass_unpack.cu`` (``byteclass_unpack`` over the
engine's ``ByteClasses``); ``_byteclass_unpack`` is its plain version.

u32 words travel as int32 bit patterns.  ``>>`` on int32 shifts
arithmetically.  Where a field never crosses a word (the ladder, the
Simple16 fields under the selector nibble, the byte classes) the mask
after the shift removes the sign fill.  QMX rows that join two words OR
the low word's shifted bits with the high word's before the mask, so
their right shifts are made logical by a mask of the 32 - s bits the
shift keeps.  The salt is added in wrapping int32.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..codecs import interpolative, vbyte
from ..config import BLOCK_SIZE
from .decode_local import _to_i32

_MASK = 0xFFFFFFFF


@dataclass
class WidthClass:
    b: int
    # ladder plans from the numpy route: the block VALUES (N, vpb) u32,
    # which the engine packs at width b; empty when ``prepacked`` is set
    payload: np.ndarray
    out_base: np.ndarray  # (N,) i64 global output offset of each block
    size: np.ndarray  # (N,) i64 ints in each block (== values_per_block)
    # per-block u32 subtracted at plan time and broadcast-added back on
    # the device (monotone streams pack at the width of the block's
    # SPAN, not its absolute values)
    val_base: Optional[np.ndarray] = None
    # classes from the native builders arrive ALREADY bit-packed and
    # lane-major ((W, M, 128) u32): the engine ships them as they are
    prepacked: Optional[np.ndarray] = None
    # optpfor: blocks carrying exceptions are ordered FIRST in the class,
    # aligned with exc_dense rows ((E, vpb) u32, values pre-shifted by
    # << b); the engine folds them into the host-unpacked values at load
    exc_dense: Optional[np.ndarray] = None
    # qmx: one row a QMX instance (payload (N, 16 or 32) u8, size = the
    # values the instance emits)
    qmx: bool = False


@dataclass
class UnpackPlan:
    codec: str  # 'ladder' | 'optpfor' | 'qmx'
    values_per_block: int
    classes: List[WidthClass]
    # host-decoded partial tails: (global output offset, values)
    partials: List[Tuple[int, np.ndarray]]
    total_ints: int

    def plan_bytes(self) -> int:
        t = 0
        for c in self.classes:
            t += c.payload.nbytes + c.out_base.nbytes
            if c.exc_dense is not None:
                t += c.exc_dense.nbytes
            if c.prepacked is not None:
                t += c.prepacked.nbytes
        return t


def plan_optpfor(arena: np.ndarray, meta) -> UnpackPlan:
    """Walk an optpfor vroom stream (256-chunked lists, interpolative
    partial tails — index/vroom_zoo.py layout) into width classes."""
    from ..codecs import blocks as blocks_mod

    per: Dict[int, list] = {}
    partials: List[Tuple[int, np.ndarray]] = []
    out_off = 0
    for i in range(meta.num_lists):
        n = int(meta.n[i])
        pos = int(meta.payload_off[i])
        for p in range(0, n, BLOCK_SIZE):
            size = min(BLOCK_SIZE, n - p)
            if size < BLOCK_SIZE:
                vals, pos = interpolative.decode_block(
                    arena, pos, size, blocks_mod.UNKNOWN
                )
                partials.append((out_off, vals.astype(np.uint32)))
            else:
                b = int(arena[pos])
                ne = int(arena[pos + 1]) | (int(arena[pos + 2]) << 8)
                q = pos + 3
                pay = arena[q : q + 32 * b]
                q += 32 * b
                epos = np.asarray(arena[q : q + ne], dtype=np.int64)
                q += ne
                highs = np.zeros(ne, np.int64)
                for e in range(ne):
                    hi, q = vbyte.decode_single(arena, q)
                    highs[e] = hi
                per.setdefault(b, []).append((pay, out_off, epos, highs))
                pos = q
            out_off += size
    classes = []
    for b, items in sorted(per.items()):
        # exception-bearing blocks first (dense slice-add, no scatter)
        items = sorted(items, key=lambda x: len(x[2]) == 0)
        pay = np.stack([x[0] for x in items]) if b else np.zeros(
            (len(items), 0), np.uint8
        )
        bases = np.asarray([x[1] for x in items], np.int64)
        E = sum(1 for x in items if len(x[2]))
        exc_dense = np.zeros((E, BLOCK_SIZE), np.uint32)
        for r in range(E):
            _, _, ep, hi = items[r]
            exc_dense[r, ep] = (hi << b).astype(np.uint64) & 0xFFFFFFFF
        classes.append(WidthClass(
            b, pay, bases, np.full(len(items), BLOCK_SIZE, np.int64),
            exc_dense=exc_dense,
        ))
    total = int(np.asarray(meta.n, np.int64).sum())
    return UnpackPlan("optpfor", BLOCK_SIZE, classes, partials, total)


def plan_qmx(arena: np.ndarray, meta) -> UnpackPlan:
    """Walk a qmx vroom stream (the ORIGINAL wire format, codecs/qmx.py:
    per list vbyte(len) + payload with reversed selector bytes at the
    end) into per-width instance classes.

    Every full instance of a striped width becomes one class row: its
    payload is 4 (or 8) u32 lane words and the device decode is a pure
    static shift/mask per (width, row).  Byte/short/word widths
    (8/16/32) are fixed 16-byte rows; width 0 emits runs of ONES
    generated on the device.  Only a list's clamped final byte-form
    instance and n == 1 bare-vbyte lists decode on the host
    (partials)."""
    from ..codecs import qmx as qmx_wire

    per: Dict[int, list] = {}
    partials: List[Tuple[int, np.ndarray]] = []
    out_off = 0
    for i in range(meta.num_lists):
        n = int(meta.n[i])
        pos = int(meta.payload_off[i])
        if n == 1:
            val, _ = vbyte.decode_single(arena, pos)
            partials.append((out_off, np.asarray([val], np.uint32)))
            out_off += 1
            continue
        ln, pos = vbyte.decode_single(arena, pos)
        payload = np.asarray(arena[pos : pos + ln], dtype=np.uint8)
        # selector bytes sit reversed at the payload end; walk them
        # backwards, carving instances off the forward payload
        p = 0
        k = ln - 1
        emitted = 0
        while p <= k and emitted < n:
            key = int(payload[k])
            k -= 1
            tpe = key >> 4
            low = key & 0x0F
            batch = 16 - low if low else 16
            w = qmx_wire._TYPE_TO_WIDTH[tpe]
            ints = qmx_wire._INTS[w]
            for _ in range(batch):
                take = min(ints, n - emitted)
                if take <= 0:
                    break
                if w == 0:
                    per.setdefault(0, []).append((None, out_off + emitted,
                                                  take))
                elif w in (8, 16, 32):
                    nb = w // 8
                    if take < ints:  # clamped final instance: host
                        vals = np.frombuffer(
                            payload[p : p + take * nb].tobytes(),
                            dtype={8: "<u1", 16: "<u2", 32: "<u4"}[w],
                        ).astype(np.uint32)
                        partials.append((out_off + emitted, vals))
                    else:
                        per.setdefault(w, []).append(
                            (payload[p : p + 16], out_off + emitted, take)
                        )
                    p += take * nb
                else:
                    nb = 32 if w in qmx_wire._DOUBLE else 16
                    per.setdefault(w, []).append(
                        (payload[p : p + nb], out_off + emitted, take)
                    )
                    p += nb
                emitted += take
        out_off += n
    classes = []
    for w, items in sorted(per.items()):
        if w == 0:
            pay = np.zeros((len(items), 0), np.uint8)
        else:
            pay = np.stack([x[0] for x in items])
        classes.append(WidthClass(
            w, pay,
            np.asarray([x[1] for x in items], np.int64),
            np.asarray([x[2] for x in items], np.int64),
            qmx=True,
        ))
    total = int(np.asarray(meta.n, np.int64).sum())
    return UnpackPlan("qmx", BLOCK_SIZE, classes, partials, total)


def plan_ladder(codec: str, arena: np.ndarray, meta) -> UnpackPlan:
    """Codec-independent serving image for any zoo codec: the planner
    host-decodes the stream ONCE (the native whole-list decoders of
    ``codecs/zoonative.py``), chunks the flat value stream into
    256-value blocks, and groups blocks by the smallest no-straddle
    ladder width holding each block's values.  The device then decodes
    the same canonical image whatever the wire codec (``_fns``).  PEF
    lists decode to absolute docids (monotone): each block packs its
    values relative to its minimum, which rides as a per-block base
    (``_fns_base``), so a block packs at the width of its span."""
    from ..index import vroom_zoo

    pef = codec == "pef"
    parts = []
    for i in range(meta.num_lists):
        n = int(meta.n[i])
        if pef:
            parts.append(vroom_zoo.decode_list_pef(
                arena, int(meta.payload_off[i]), int(meta.payload_len[i]),
                n, int(meta.universe[i]),
            ).astype(np.uint32, copy=False))
        else:
            parts.append(vroom_zoo.decode_list_zoo(
                codec, arena, int(meta.payload_off[i]), n,
            ).astype(np.uint32, copy=False))
    flat = np.concatenate(parts) if parts else np.zeros(0, np.uint32)
    return ladder_plan_from_values(flat, base_relative=pef)


def plan_from_numpy(classes: Sequence[Dict], partials, total_ints: int,
                    values_per_block: int = BLOCK_SIZE) -> UnpackPlan:
    """The port's ladder plan from the reference package's ``UnpackPlan``
    fields as numpy arrays: per class a mapping with ``b``, ``out_base``,
    ``size``, ``prepacked`` or ``payload`` (the other None or absent)
    and optionally ``val_base``; ``partials`` [(offset, values)];
    ``total_ints``.  Both engines can then run one plan."""
    wcs = []
    for c in classes:
        out_base = np.asarray(c["out_base"], np.int64)
        pre = c.get("prepacked")
        pay = c.get("payload")
        vb = c.get("val_base")
        wcs.append(WidthClass(
            int(c["b"]),
            (np.asarray(pay) if pay is not None
             else np.zeros((out_base.shape[0], 0), np.uint8)),
            out_base, np.asarray(c["size"], np.int64),
            val_base=None if vb is None else np.asarray(vb, np.uint32),
            prepacked=None if pre is None else np.asarray(pre, np.uint32),
        ))
    parts = [(int(o), np.asarray(v, np.uint32)) for o, v in partials]
    return UnpackPlan("ladder", values_per_block, wcs, parts, int(total_ints))


# serving-image width ladder: the distinct no-straddle container widths
# (vpw = 32 // w values per u32 word, values never cross a word); the
# smallest ladder width >= a block's needed bit width is its class
_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 16, 32)


def _ladder_width(w_need: int) -> int:
    for w in _LADDER:
        if w >= w_need:
            return w
    return 32


def _pack_w(values: np.ndarray, w: int) -> np.ndarray:
    """(N, vpb) u32 values (< 2^w) -> (N, ceil(vpb/vpw)) u32 words with
    vpw = 32//w little-endian w-bit fields per word (no value straddles
    a word; value j of a row sits in word j//vpw at shift (j%vpw)*w).
    The value axis zero-pads up to a whole word."""
    vpw = 32 // w
    N, vpb = values.shape
    W = -(-vpb // vpw)
    if W * vpw != vpb:
        values = np.concatenate(
            [values, np.zeros((N, W * vpw - vpb), np.uint32)], axis=1
        )
    v = values.reshape(N, W, vpw).astype(np.uint64)
    shifts = np.arange(vpw, dtype=np.uint64) * np.uint64(w)
    return (v << shifts).sum(axis=2, dtype=np.uint64).astype(np.uint32)


def _lane_major(words: np.ndarray) -> np.ndarray:
    """(N, W) u32 -> (W, M, 128): word k of row i at [k, i//128, i%128],
    zero-padded to the lane grid."""
    N, W = words.shape
    M = max(1, (N + 127) // 128)
    out = np.zeros((W, M * 128), np.uint32)
    out[:, :N] = words.T
    return np.ascontiguousarray(out.reshape(W, M, 128))


def ladder_plan_from_values(flat: np.ndarray, base_relative: bool = False,
                            native: bool = True) -> UnpackPlan:
    """Build the canonical ladder UnpackPlan from an already-decoded
    flat value stream (stream order).  base_relative=True subtracts
    each block's minimum and ships it as val_base (monotone docid
    streams); False packs absolute values (gap streams).

    The classify + pack + lane-transpose passes run natively
    (query_host.cpp qh_ladder_from_values) and raise if that library
    does not build; ``native=False`` runs the numpy passes, the oracle
    the native route is tested against."""
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    if native:
        from ..query import native_host

        classes, tail = native_host.ladder_from_values(
            flat, BLOCK_SIZE, base_relative)
        return ladder_plan_prepacked(classes, tail, int(flat.shape[0]))
    total = int(flat.shape[0])
    vpb = BLOCK_SIZE
    nb = total // vpb
    blocks = flat[: nb * vpb].reshape(nb, vpb)
    tail = flat[nb * vpb:]
    partials = [(nb * vpb, tail.copy())] if tail.size else []
    classes: List[WidthClass] = []
    if nb:
        base = (blocks.min(axis=1) if base_relative
                else np.zeros(nb, np.uint32)).astype(np.uint32)
        rel = blocks - base[:, None] if base_relative else blocks
        mx = rel.max(axis=1)
        w_need = np.ceil(
            np.log2(mx.astype(np.float64) + 1.0)
        ).astype(np.int64)
        w_need = np.maximum(w_need, 1)
        lw = np.asarray([_ladder_width(int(w)) for w in w_need])
        for w in sorted(set(lw.tolist())):
            rows = np.flatnonzero(lw == w)
            # payload carries the VALUES (u32); the engine packs them at
            # width w into the device image
            classes.append(
                WidthClass(
                    int(w), rel[rows],
                    rows.astype(np.int64) * vpb,
                    np.full(rows.size, vpb, np.int64),
                    val_base=(base[rows] if base_relative else None),
                )
            )
    return UnpackPlan("ladder", vpb, classes, partials, total)


def ladder_plan_prepacked(classes, tail: np.ndarray,
                          total: int) -> UnpackPlan:
    """Wrap a native builder's output as a ladder UnpackPlan: ``classes``
    is [(w, lane_major (W, M, 128) u32, out_base (N,) i64[, val_base])],
    already bit-packed and lane-transposed; the engine uploads them as
    they are.  Semantically identical to ladder_plan_from_values over
    the same value stream."""
    vpb = BLOCK_SIZE
    wcs: List[WidthClass] = []
    for cls in classes:
        w, lane, out_base = cls[:3]
        vbase = cls[3] if len(cls) > 3 else None
        n = out_base.shape[0]
        wcs.append(
            WidthClass(
                int(w), np.zeros((n, 0), np.uint8), out_base,
                np.full(n, vpb, np.int64), prepacked=lane,
                val_base=vbase,
            )
        )
    nb = (total - int(tail.shape[0])) // vpb
    partials = [(nb * vpb, tail)] if tail.size else []
    return UnpackPlan("ladder", vpb, wcs, partials, total)


@functools.lru_cache(maxsize=None)
def _shifts(w: int, device) -> torch.Tensor:
    """(1, vpw, 1, 1) int32 field shifts of width ``w`` on ``device``
    (ten widths a device: kept, so a decode builds none)."""
    vpw = 32 // w
    return (torch.arange(vpw, dtype=torch.int32, device=device)
            * w)[None, :, None, None]


def _fns(w: int):
    """Device decode for one ladder width class: every value lives whole
    inside one u32 word at shift (r * w), so the unpack is a single
    broadcast (W', 1, M, 128) >> (1, vpw, 1, 1) producing
    (W', vpw, M, 128).  Value j of block i sits at
    [j // vpw, j % vpw, i // 128, i % 128].  ``salt`` is a 0-d or (1,)
    int32 tensor, wrap-added to every value."""
    mask = (1 << w) - 1

    def unpack(wT, hi, salt):
        del hi
        out = wT[:, None] >> _shifts(w, wT.device)  # (W', vpw, M, 128)
        if w < 32:
            out &= mask
        return out.add_(salt)

    return unpack


def _fns_base(w: int):
    """Ladder unpack + per-block base broadcast-add (blocks pack RELATIVE
    values at their span width; the block minimum rides as one u32 per
    lane, ``bT`` (M, 128), and adds back here)."""
    mask = (1 << w) - 1

    def unpack(wT, bT, salt):
        out = wT[:, None] >> _shifts(w, wT.device)  # (W', vpw, M, 128)
        if w < 32:
            out &= mask
        return out.add_((bT + salt)[None, None])

    return unpack


def _logical_mask(shifts) -> np.ndarray:
    """Per-row masks of the 32 - s bits a right shift by s keeps, as
    int32 values: ``(x >> s) & mask`` is the logical shift of x's u32
    bits."""
    m = (np.int64(1) << (32 - np.asarray(shifts, np.int64))) - 1
    return np.where(m >= 1 << 31, m - (1 << 32), m)


@functools.lru_cache(maxsize=None)
def _qmx_consts(w: int, device):
    """(lo shifts, lo logical masks, spill left shifts, spill rows, high
    shifts, high logical masks, high-only rows) of a striped QMX width,
    each (1, R, 1, 1) on ``device`` (kept, so a decode builds none)."""
    from ..codecs import qmx as qmx_wire

    shifts = np.asarray(qmx_wire._ROW_SHIFTS[w], np.int64)
    spill = (shifts < 32) & (shifts + w > 32)
    high_only = shifts >= 32
    s_lo = np.where(shifts < 32, shifts, 0)
    s_sp = np.where(spill, 32 - shifts, 0)
    s_hi = np.where(high_only, shifts - 32, 0)

    def col(x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), dtype=dtype).reshape(
            1, -1, 1, 1).to(device)

    return (col(s_lo), col(_logical_mask(s_lo)), col(s_sp),
            col(spill, torch.bool), col(s_hi), col(_logical_mask(s_hi)),
            col(high_only, torch.bool))


def _qmx_fns(w: int):
    """Device decode for one QMX width class: one broadcast unpack.

    Lane words live lane-major: lo (4, M, 128) int32 (plus hi (4, M, 128)
    for the 32-byte double-word widths), one class instance a lane.  The
    unpack broadcasts the width's static per-row shift vector
    (codecs/qmx.py _ROW_SHIFTS, incl. the 12/21 gap bits) over a new row
    axis: out (4, R, M, 128).  Value j of instance i sits at
    [j & 3, j >> 2, i // 128, i % 128]; the byte-form widths 8/16/32
    remap their 4 payload words as (word, sub) with j = word * R + sub,
    and width 0 generates ones (its lo is a (1, M, 1) placeholder)."""
    if w == 0:
        def unpack(lo, hi, salt):
            del hi
            M = lo.shape[1]
            out = torch.ones((4, 64, M, 128), dtype=torch.int32,
                             device=lo.device)
            return out.add_(salt)

        return unpack

    if w in (8, 16, 32):
        R = 4 // (w // 8)
        mask = (1 << w) - 1

        def unpack(lo, hi, salt):
            del hi
            s = (torch.arange(R, dtype=torch.int32, device=lo.device)
                 * w)[None, :, None, None]
            out = lo[:, None] >> s  # (4, R, M, 128)
            if w < 32:
                out &= mask
            return out.add_(salt)

        return unpack

    mask = (1 << w) - 1

    def unpack(lo, hi, salt):
        s_lo, m_lo, s_sp, spill, s_hi, m_hi, high_only = _qmx_consts(
            w, lo.device)
        # the lo word's bits join the hi word's spill before the mask:
        # logical shifts
        v = (lo[:, None] >> s_lo) & m_lo
        if hi is not None:
            v = torch.where(high_only, (hi[:, None] >> s_hi) & m_hi, v)
            v |= torch.where(spill, hi[:, None] << s_sp, 0)
        return (v & mask).add_(salt)  # (4, R, M, 128)

    return unpack


def _kind_fns(kind: str, b: int):
    if kind == "qmx":
        return _qmx_fns(b)
    if kind == "pforb":
        return _fns_base(b)
    return _fns(b)


# ---------------------------------------------------------------------------
# X1: the fused ladder unpack (csrc/ladder_unpack.cu), one launch a run
# ---------------------------------------------------------------------------

_X1_LIB = "libdintladder.so"
X1_MAX_CLASSES = 32
X1_WORDS_PER_BLOCK = 1024  # 256 threads, four lane-major words each
X1_ROWS_PER_BLOCK = 4  # rows entry: 256 threads, four values each


def ladder_table(geometry, per_block: int) -> np.ndarray:
    """X1's class table without its pointers: one row of eight int64 per
    class, (src, base, out, a, b, block0, w, 0), for ``geometry`` [(w, a,
    b, blocks)]: a class takes ``blocks`` blocks of the grid from
    ``block0``, the running sum of the classes before it, which is how
    a block of the launch finds its class.  The engine's layout has a =
    M * 128 lanes a plane, b = W' * a words, ``per_block`` =
    X1_WORDS_PER_BLOCK; the sharded rows have a = NBw rows, b = words a
    row, ``per_block`` = X1_ROWS_PER_BLOCK."""
    if len(geometry) > X1_MAX_CLASSES:
        raise ValueError(f"X1 takes at most {X1_MAX_CLASSES} classes a "
                         f"launch, got {len(geometry)}")
    t = np.zeros((len(geometry), 8), np.int64)
    block0 = 0
    for i, (w, a, b, work) in enumerate(geometry):
        if w not in _LADDER:
            raise ValueError(f"X1: width {w} is not a ladder width")
        t[i, 3:7] = (a, b, block0, w)
        block0 += -(-int(work) // per_block)
    return t


def _x1_check(name: str, tensors, device, aligned: bool) -> None:
    """Every tensor int32 on ``device``; with ``aligned``, on a CUDA
    device also contiguous and 16-byte aligned (the unpack entry reads
    its words and bases as uint4; the rows entry reads scalar words)."""
    for x in tensors:
        if x.dtype != torch.int32 or x.device != device:
            raise ValueError(f"{name}: every tensor must be int32 on "
                             f"{device}, got {x.dtype} on {x.device}")
        if aligned and device.type == "cuda" and (not x.is_contiguous()
                                                  or x.data_ptr() % 16):
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             "16-byte aligned")


class LadderClasses:
    """The pfor/pforb width classes of one engine as X1 decodes them:
    ``classes`` [(w, wT (W', M, 128) int32, bT (M, 128) int32 or None)] on
    one device, their outputs ``outs`` [(W', vpw, M, 128) int32], views
    of one buffer ``buf`` (class c from ``offsets[c]``) allocated once
    and rewritten by every ``ladder_unpack``, and the class table.  The
    object holds every tensor the table points at."""

    def __init__(self, classes, device):
        # the device as a tensor reports it (cuda:0 for "cuda")
        self.device = torch.empty(0, device=device).device
        device = self.device
        self.classes = list(classes)
        shapes = [(wT.shape[0], 32 // w, *wT.shape[1:])
                  for w, wT, _ in self.classes]
        sizes = [int(np.prod(sh)) for sh in shapes]
        self.offsets = np.cumsum([0] + sizes)[:-1].astype(np.int64)
        self.buf = torch.empty(sum(sizes), dtype=torch.int32, device=device)
        # every class's numel is a multiple of 128: each view is aligned
        self.outs = [self.buf[o : o + n].view(sh) for o, n, sh in
                     zip(self.offsets.tolist(), sizes, shapes)]
        geometry = []
        for w, wT, bT in self.classes:
            if wT.dim() != 3 or wT.shape[2] != 128:
                raise ValueError(f"ladder_unpack: wT must be (W', M, 128), "
                                 f"got {tuple(wT.shape)}")
            if bT is not None and tuple(bT.shape) != tuple(wT.shape[1:]):
                raise ValueError(f"ladder_unpack: bT must be "
                                 f"{tuple(wT.shape[1:])}, got "
                                 f"{tuple(bT.shape)}")
            _x1_check("ladder_unpack", [wT] + ([bT] if bT is not None
                                               else []), device, True)
            P = wT.shape[1] * 128
            geometry.append((w, P, wT.numel(), wT.numel()))
        self.table = ladder_table(geometry, X1_WORDS_PER_BLOCK)
        if device.type == "cuda":
            for row, (_, wT, bT), out in zip(self.table, self.classes,
                                             self.outs):
                row[:3] = (wT.data_ptr(),
                           bT.data_ptr() if bT is not None else 0,
                           out.data_ptr())

    def plain(self, salt: torch.Tensor) -> List[torch.Tensor]:
        """X1's plain version: ``_fns``/``_fns_base`` class by class."""
        s32 = _to_i32(salt.reshape(()) & _MASK)
        return [(_fns(w)(wT, None, s32) if bT is None
                 else _fns_base(w)(wT, bT, s32))
                for w, wT, bT in self.classes]


def ladder_unpack(lc: LadderClasses, salt: torch.Tensor) -> List[torch.Tensor]:
    """X1: every class of ``lc`` unpacked into ``lc.outs`` with ``salt``
    (a 1-element int64 tensor holding the u32 value) wrap-added; returns
    ``lc.outs``.  On a CUDA device this is ONE launch of
    ``dint_ladder_unpack`` (or the call raises); on the CPU the plain
    version."""
    name = "ladder_unpack"
    if salt.dtype != torch.int64 or salt.numel() != 1:
        raise ValueError(f"{name}: salt must be a 1-element int64 tensor")
    if salt.device != lc.device:
        raise ValueError(f"{name}: salt on {salt.device}, the classes on "
                         f"{lc.device}")
    if lc.device.type == "cpu":
        for out, got in zip(lc.outs, lc.plain(salt)):
            out.copy_(got)
        return lc.outs
    if lc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lc.device}")
    if not lc.classes:
        return lc.outs
    from . import cuda_ext

    stream = torch.cuda.current_stream(lc.device).cuda_stream
    rc = cuda_ext.lib(_X1_LIB).dint_ladder_unpack(
        lc.table.ctypes.data, lc.table.shape[0], salt.data_ptr(), stream)
    cuda_ext.check(_X1_LIB, "dint_ladder_unpack", rc)
    ladder_unpack.launches += 1
    return lc.outs


def _row_words(w: int) -> int:
    return -(-BLOCK_SIZE // (32 // w))


def ladder_rows_plain(a: torch.Tensor, w: int) -> torch.Tensor:
    """The rows entry's plain version for one width: (NBw, words_w)
    int32 -> (NBw, 256) int32, value j of a row from word j // vpw at
    shift (j % vpw) * w (the sharded step's broadcast shift and mask)."""
    vpw = 32 // w
    j = torch.arange(BLOCK_SIZE, device=a.device)
    vals = a[:, j // vpw] >> ((j % vpw) * w).to(torch.int32)[None, :]
    if w < 32:
        vals = vals & ((1 << w) - 1)
    return vals


def ladder_rows(packed: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """X1's second entry, the sharded step's row-major layout: {w:
    (NBw, words_w) int32 holding u32 words} -> {w: (NBw, 256) int32}.  On
    a CUDA device ONE launch of ``dint_ladder_rows`` over every width (or
    the call raises); on the CPU ``ladder_rows_plain``.  Any view
    decodes, as in the reference's step: the kernel reads scalar words
    at any 4-byte offset (a rank's slice of one uploaded (S, NBw,
    words_w) tensor), and a view whose rows are not contiguous is
    copied to a fresh tensor first."""
    name = "ladder_rows"
    if not packed:
        return {}
    dev = next(iter(packed.values())).device
    for w, a in packed.items():
        if w not in _LADDER:
            raise ValueError(f"{name}: width {w} is not a ladder width")
        if a.dim() != 2 or a.shape[1] != _row_words(w):
            raise ValueError(f"{name}: width {w} wants (rows, "
                             f"{_row_words(w)}) words, got {tuple(a.shape)}")
    _x1_check(name, list(packed.values()), dev, False)
    if dev.type == "cpu":
        return {w: ladder_rows_plain(a, w) for w, a in packed.items()}
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    # the kernel walks a class's rows at a stride of words_w words
    packed = {w: a.contiguous() for w, a in packed.items()}
    outs = {w: torch.empty((a.shape[0], BLOCK_SIZE), dtype=torch.int32,
                           device=dev) for w, a in packed.items()}
    live = [w for w, a in packed.items() if a.shape[0]]
    if not live:
        return outs
    table = ladder_table([(w, packed[w].shape[0], _row_words(w),
                           packed[w].shape[0]) for w in live],
                         X1_ROWS_PER_BLOCK)
    for row, w in zip(table, live):
        row[0], row[2] = packed[w].data_ptr(), outs[w].data_ptr()
    from . import cuda_ext

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_ext.lib(_X1_LIB).dint_ladder_rows(
        table.ctypes.data, table.shape[0], stream)
    cuda_ext.check(_X1_LIB, "dint_ladder_rows", rc)
    ladder_rows.launches += 1
    return outs


ladder_unpack.launches = 0
ladder_rows.launches = 0


class UnpackEngine:
    """Runs one UnpackPlan on ``device`` (class-major outputs).

    At load the plan compiles into lane-major device images — one class
    row a lane — so every width class decodes as one broadcast unpack
    (``_fns``, ``_fns_base``, ``_qmx_fns``).  Ladder classes ship as
    planned; qmx instances ship their lane words; optpfor blocks are
    unpacked on the host, their exception highs folded into the values,
    and re-grouped by the smallest no-straddle ladder width that holds
    the folded values.  ``device_bytes`` reports the image size next to
    the plan's wire-faithful ``plan_bytes``; ``self._meta`` carries each
    device class's (out_base, size) block mapping."""

    CODECS = ("ladder", "qmx", "optpfor")

    def __init__(self, plan: UnpackPlan, device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self._dev = []   # (kind, w, a0, a1) per device class
        self._meta = []  # (out_base, size) per device class
        self.device_bytes = 0
        if plan.codec not in self.CODECS:
            raise ValueError(f"codec {plan.codec!r} not in {self.CODECS}")
        if plan.codec == "ladder":
            for c in plan.classes:
                wT = _u32_tensor(
                    c.prepacked if c.prepacked is not None else
                    _lane_major(_pack_w(c.payload.astype(np.uint32), c.b)),
                    self.device)
                if c.val_base is not None:
                    bT = _u32_tensor(_lane_major(
                        c.val_base[:, None].astype(np.uint32))[0],
                        self.device)  # (M, 128)
                    self._dev.append(("pforb", int(c.b), wT, bT))
                    self.device_bytes += bT.numel() * 4
                else:
                    self._dev.append(("pfor", int(c.b), wT, None))
                self._meta.append((c.out_base, c.size))
                self.device_bytes += wT.numel() * 4
        elif plan.codec == "qmx":
            for c in plan.classes:
                n = c.payload.shape[0]
                self._meta.append((c.out_base, c.size))
                if c.b == 0:
                    # width-0 instances decode to ones on the device;
                    # only the lane-grid height is needed
                    M = max(1, (n + 127) // 128)
                    self._dev.append(("qmx", 0, torch.zeros(
                        (1, M, 1), dtype=torch.int32, device=self.device),
                        None))
                    continue
                words = _payload_words(c.payload)
                lo = _u32_tensor(_lane_major(words[:, :4]), self.device)
                hi = (_u32_tensor(_lane_major(words[:, 4:8]), self.device)
                      if words.shape[1] > 4 else None)
                self._dev.append(("qmx", int(c.b), lo, hi))
                self.device_bytes += (lo.numel() + (
                    hi.numel() if hi is not None else 0)) * 4
        else:
            self._fold_optpfor(plan)
        # the pfor/pforb classes decode in one X1 launch; qmx classes
        # keep their torch ops
        x1 = [i for i, d in enumerate(self._dev) if d[0] != "qmx"]
        self._x1_pos = {i: k for k, i in enumerate(x1)}
        self._x1 = LadderClasses([self._dev[i][1:] for i in x1],
                                 self.device)

    def _fold_optpfor(self, plan: UnpackPlan) -> None:
        """optpfor: unpack every block on the host, fold the exception
        highs into the values (exception blocks are ordered first in each
        plan class, aligned with exc_dense rows), then re-classify each
        block by the smallest ladder width that holds its folded values;
        a device class keeps the plan classes' order and their row
        order."""
        vpb = plan.values_per_block
        per_w: Dict[int, list] = {}
        for c in plan.classes:
            n = c.payload.shape[0]
            if c.b == 0:
                values = np.zeros((n, vpb), np.uint32)
            else:
                values = _np_phase_unpack(_payload_words(c.payload),
                                          int(c.b), vpb)
            if c.exc_dense is not None and c.exc_dense.shape[0]:
                values[: c.exc_dense.shape[0]] += c.exc_dense
            # needed bit width per block (exact for ints <= 2^32 in f64)
            w_need = np.ceil(
                np.log2(values.max(axis=1).astype(np.float64) + 1.0)
            ).astype(np.int64)
            lw = np.asarray([_ladder_width(int(w))
                             for w in np.maximum(w_need, 1)], np.int64)
            for w in np.unique(lw):
                rows = np.flatnonzero(lw == w)
                per_w.setdefault(int(w), []).append(
                    (values[rows], c.out_base[rows], c.size[rows]))
        for w in sorted(per_w):
            items = per_w[w]
            wT = _u32_tensor(_lane_major(_pack_w(
                np.concatenate([x[0] for x in items]), w)), self.device)
            self._dev.append(("pfor", w, wT, None))
            self._meta.append((
                np.concatenate([x[1] for x in items]).astype(np.int64),
                np.concatenate([x[2] for x in items]).astype(np.int64),
            ))
            self.device_bytes += wT.numel() * 4

    @staticmethod
    def _reorder(kind: str, b: int, out: np.ndarray, n: int) -> np.ndarray:
        """(.., .., M, 128) class output -> (N, ints) in value order."""
        if kind in ("pfor", "pforb") or b in (8, 16, 32):
            # value j at [j // R2, j % R2, i // 128, i % 128]
            a = np.transpose(out, (2, 3, 0, 1))
        else:
            # striped: value j at [j & 3, j >> 2, ...]
            a = np.transpose(out, (2, 3, 1, 0))
        return a.reshape(a.shape[0] * a.shape[1], -1)[:n]

    def decode_classes(self) -> List[np.ndarray]:
        salt = torch.zeros((), dtype=torch.int64, device=self.device)
        x1 = ladder_unpack(self._x1, salt) if self._x1.classes else []
        outs = []
        for i, ((out_base, _), (kind, b, a0, a1)) in enumerate(
                zip(self._meta, self._dev)):
            out = (x1[self._x1_pos[i]] if i in self._x1_pos
                   else _qmx_fns(b)(a0, a1, _to_i32(salt)))
            outs.append(self._reorder(kind, b,
                                      out.cpu().numpy().view(np.uint32),
                                      out_base.shape[0]))
        return outs

    def _sample_index(self) -> torch.Tensor:
        """Positions in X1's buffer of the chain's sample of each X1
        class, ``out[:1, :1, :8]``: the first min(8, M) * 128 values of
        the class's (0, 0) plane, which starts the class."""
        idx = [np.arange(o, o + min(8, wT.shape[1]) * 128)
               for o, (_, wT, _) in zip(self._x1.offsets, self._x1.classes)]
        return torch.from_numpy(np.concatenate(
            idx or [np.zeros(0, np.int64)])).to(self.device)

    def chain(self, runs: int) -> torch.Tensor:
        """``runs`` full decodes back to back from salt 1, every width
        class each run, and the final checksum as a 0-d int64 device
        tensor holding a u32 value.  Each run is salted; its checksum is
        the u32 sum of a sample of every class's output
        (``out[:1, :1, :8]``) and of the salted partial tails, minus the
        salt's share, and is the next run's salt.  Nothing is fetched to
        the host in between."""
        pvals = torch.from_numpy(np.concatenate(
            [v for _, v in self.plan.partials] or [np.zeros(0, np.uint32)]
        ).astype(np.uint32).view(np.int32)).to(self.device)
        qmx = [d for i, d in enumerate(self._dev) if i not in self._x1_pos]
        sample = self._sample_index() if self._x1.classes else None
        salt = torch.ones((), dtype=torch.int64, device=self.device)
        for _ in range(runs):
            # the u32 salt's int32 bits (an int64 -> int32 conversion
            # keeps the low 32 bits)
            s32 = salt.to(torch.int32)
            samples = []
            if sample is not None:
                # X1's one launch; the chain reads its sample before the
                # next run's launch rewrites the buffer, on the same
                # stream
                ladder_unpack(self._x1, salt)
                samples.append(torch.index_select(self._x1.buf, 0, sample))
            for _, b, a0, a1 in qmx:
                samples.append(_qmx_fns(b)(a0, a1, s32)[:1, :1, :8]
                               .reshape(-1))
            # partial tails are hosted plan values; per run they
            # materialize on the device like every other value
            samples.append(pvals + s32)
            samp = torch.cat(samples) if len(samples) > 1 else samples[0]
            total = samp.sum(dtype=torch.int32).to(torch.int64)
            salt = torch.sub(total, salt, alpha=samp.numel()).bitwise_and_(
                _MASK)
        return salt

    def timed_chain(self, runs: int) -> float:
        """Seconds for ``runs`` chained full device decodes after one
        warm-up chain; the final checksum is kept in
        ``self.final_checksum``.  On the card the chain is timed with
        CUDA events, on the CPU with the host clock."""
        elapsed, self.final_checksum = _timed(self.chain, runs, self.device)
        return elapsed

    def decode_all_ordered(self) -> np.ndarray:
        """Full stream decode assembled back to stream order (host
        reorder; used by the collection check)."""
        out = np.zeros(self.plan.total_ints, np.uint32)
        for (out_base, size), vals in zip(self._meta, self.decode_classes()):
            _scatter_rows(out, out_base, size, vals)
        for off, vals in self.plan.partials:
            out[off : off + vals.shape[0]] = vals
        return out


def _payload_words(pay8: np.ndarray) -> np.ndarray:
    """(N, bytes) u8 payload rows -> (N, ceil(bytes / 4)) little-endian
    u32 words (the last word zero-padded)."""
    padc = (-pay8.shape[1]) % 4
    if padc:
        pay8 = np.concatenate(
            [pay8, np.zeros((pay8.shape[0], padc), np.uint8)], axis=1)
    return np.ascontiguousarray(pay8).view("<u4")


def _scatter_rows(out: np.ndarray, out_base, size, vals: np.ndarray) -> None:
    """out[out_base[r] + j] = vals[r, j] for j < size[r]."""
    out_base = np.asarray(out_base, np.int64)
    size = np.asarray(size, np.int64)
    lanes = np.arange(vals.shape[1], dtype=np.int64)
    keep = lanes[None, :] < size[:, None]
    out[(out_base[:, None] + lanes)[keep]] = vals[keep]


def _timed(chain, runs: int, device: torch.device) -> Tuple[float, int]:
    """(seconds, final checksum) of ``chain(runs)`` after one warm-up
    chain: CUDA events on the card, the host clock on the CPU."""
    int(chain(runs).item())  # warm-up
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        final = chain(runs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, int(final.item())
    t0 = time.perf_counter()
    final = int(chain(runs).item())
    return time.perf_counter() - t0, final


def _u32_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a, np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# Simple16: one class a selector mode
# ---------------------------------------------------------------------------


def plan_simple16(arena: np.ndarray, meta) -> "Simple16Plan":
    """Walk a simple16 vroom stream into MODE classes: every 28-bit
    payload word with selector m decodes as a fixed set of static
    shifts, so a mode class is just a dense u32 word array — no
    gathers, no bit chains, pure elementwise device work."""
    from ..codecs.blocks import _S16_MODES
    from ..codecs.encode_batch import OPT_CHUNK

    per: Dict[int, list] = {i: [] for i in range(len(_S16_MODES))}
    out_off = 0
    for i in range(meta.num_lists):
        n = int(meta.n[i])
        pos = int(meta.payload_off[i])
        # lists are OPT_CHUNK-chunked (vroom_zoo.encode_list_zoo): each
        # chunk is an independent simple16 stream, so `take` caps at
        # the CHUNK end, not the list end
        for c0 in range(0, max(n, 1), OPT_CHUNK):
            cend = min(c0 + OPT_CHUNK, n)
            done = c0
            while done < cend:
                w = (
                    int(arena[pos])
                    | (int(arena[pos + 1]) << 8)
                    | (int(arena[pos + 2]) << 16)
                    | (int(arena[pos + 3]) << 24)
                )
                pos += 4
                mode = w >> 28
                cnt, bits = _S16_MODES[mode]
                take = min(cnt, cend - done)
                per[mode].append((w, out_off + done, take))
                done += take
        out_off += n
    classes = []
    for mode, items in per.items():
        cnt, bits = _S16_MODES[mode]
        words = np.asarray([x[0] for x in items], np.uint32)
        bases = np.asarray([x[1] for x in items], np.int64)
        takes = np.asarray([x[2] for x in items], np.int64)
        classes.append((mode, cnt, bits, words, bases, takes))
    total = int(np.asarray(meta.n, np.int64).sum())
    return Simple16Plan(classes, total)


@dataclass
class Simple16Plan:
    classes: list  # (mode, cnt, bits, words u32, out_bases, takes)
    total_ints: int

    def plan_bytes(self) -> int:
        return sum(c[3].nbytes + c[4].nbytes for c in self.classes)


def _s16_unpack(words_i32: torch.Tensor, cnt: int, bits: int,
                salt) -> torch.Tensor:
    """(M, 128) int32 selector words -> (M, cnt, 128) int32 fields +
    salt: one broadcast shift/mask for the whole mode class (the 28-bit
    payload of mode (cnt, bits)).  Every field lies under the selector
    nibble and is masked after its shift, so int32's arithmetic shift
    is safe."""
    shifts = (torch.arange(cnt, dtype=torch.int32, device=words_i32.device)
              * bits)[None, :, None]
    out = (words_i32[:, None, :] >> shifts) & ((1 << bits) - 1)
    return out.add_(salt)


def _s16_fns(cnt: int, bits: int):
    """The class decode without a salt: (M, 128) words -> (M, cnt, 128)."""
    def decode(words):
        return _s16_unpack(words, cnt, bits, 0)

    return decode


class Simple16Engine:
    """Device decode of a simple16 plan on ``device``: per mode class one
    broadcast unpack over lane-aligned words.  Words reshape on the host
    to (M, 128) — one class row a lane — and the unpack is a single
    broadcast (M, 1, 128) >> (1, cnt, 1) producing (M, cnt, 128)."""

    def __init__(self, plan: Simple16Plan, device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self._dev = []
        for mode, cnt, bits, words, _, _ in plan.classes:
            n = words.shape[0]
            if not n:
                continue
            M = (n + 127) // 128
            w2 = np.zeros((M, 128), np.uint32)
            w2.reshape(-1)[:n] = words
            self._dev.append((mode, cnt, bits, n,
                              _u32_tensor(w2, self.device)))

    def decode_classes(self) -> Dict[int, np.ndarray]:
        outs = {}
        for mode, cnt, bits, n, w in self._dev:
            out = _s16_fns(cnt, bits)(w).cpu().numpy().view(np.uint32)
            # value j of word r lives at [r // 128, j, r % 128]
            outs[mode] = np.moveaxis(out, 1, 2).reshape(-1, cnt)[:n]
        return outs

    def chain(self, runs: int) -> torch.Tensor:
        """``runs`` decodes back to back from salt 1, every mode class
        materialised each run; the checksum is the u32 sum of each
        class's first 8 lane rows, minus the salt's share, plus
        salt + 1, and is the next run's salt.  Returns it as a 0-d int64
        device tensor holding a u32 value."""
        salt = torch.ones((), dtype=torch.int64, device=self.device)
        for _ in range(runs):
            s32 = _to_i32(salt)
            samples = [_s16_unpack(w, cnt, bits, s32)[:8].reshape(-1)
                       for _, cnt, bits, _, w in self._dev]
            samp = (torch.cat(samples) if samples else
                    torch.zeros(0, dtype=torch.int32, device=self.device))
            total = samp.sum(dtype=torch.int32).to(torch.int64)
            salt = (total - salt * samp.numel() + salt + 1) & _MASK
        return salt

    def timed_chain(self, runs: int) -> float:
        """Seconds for ``runs`` chained decodes after a warm-up chain;
        the final checksum is kept in ``self.final_checksum``."""
        elapsed, self.final_checksum = _timed(self.chain, runs, self.device)
        return elapsed

    def decode_all_ordered(self) -> np.ndarray:
        outs = self.decode_classes()
        res = np.zeros(self.plan.total_ints, np.uint32)
        for mode, cnt, bits, words, bases, takes in self.plan.classes:
            if words.shape[0]:
                _scatter_rows(res, bases, takes, outs[mode])
        return res


# ---------------------------------------------------------------------------
# Byte-length classes: vbyte, maskedvbyte, streamvbyte, varintgb, varintg8iu
# ---------------------------------------------------------------------------


@dataclass
class ByteClassPlan:
    """Byte-length-class plan for the byte-granular codecs.

    Every value of a streamvbyte / varintgb / maskedvbyte / vbyte
    stream occupies 1..5 whole bytes; at load the planner excises each
    value's bytes into the dense array of its LENGTH class, so the
    device decode is one fused shift/or per class.  group_bits is 8
    for plain byte codecs, 7 for the vbyte family (marker bits masked
    off)."""

    codec: str
    group_bits: int
    classes: list  # (length, bytes (N, length) u8, out_base (N,) i64)
    total_ints: int
    # host-decoded partial tails (varint_G8IU's interpolative blocks):
    # (global output offset, values)
    partials: list = field(default_factory=list)

    def plan_bytes(self) -> int:
        return sum(c[1].nbytes + c[2].nbytes for c in self.classes)


def _byteclass_from_slices(codec, group_bits, data, starts, lens, total,
                           out_index=None, partials=None):
    per = {}
    if out_index is None:
        out_index = np.arange(starts.shape[0], dtype=np.int64)
    for L in np.unique(lens):
        if L <= 0:
            continue
        sel = np.flatnonzero(lens == L)
        idx = starts[sel][:, None] + np.arange(int(L))[None, :]
        per[int(L)] = (data[idx], out_index[sel].astype(np.int64))
    classes = [(L, b, o) for L, (b, o) in sorted(per.items())]
    return ByteClassPlan(codec, group_bits, classes, total, partials or [])


def plan_byteclass(codec: str, arena: np.ndarray, meta) -> ByteClassPlan:
    """Walk a byte-codec vroom stream into length classes.  Value
    positions come from the formats' own structure (ctrl codes /
    key bytes / marker bits), vectorized with the host decoders'
    machinery."""
    from ..codecs import blocks as blocks_mod
    from ..codecs.encode_batch import OPT_CHUNK

    offs = meta.payload_off.astype(np.int64)
    lens_pl = meta.payload_len.astype(np.int64)
    ns = meta.n.astype(np.int64)
    total = int(ns.sum())
    all_starts = np.zeros(total, np.int64)  # global value byte starts
    all_lens = np.zeros(total, np.int64)
    # flat excised payload (values are contiguous within each list's
    # payload; headers between lists are skipped via the excision)
    flat = np.concatenate(
        [arena[offs[i] : offs[i] + lens_pl[i]] for i in range(meta.num_lists)]
    ) if meta.num_lists else np.zeros(0, np.uint8)
    flat = np.concatenate([flat, np.zeros(8, np.uint8)])
    pl_base = np.concatenate([[0], np.cumsum(lens_pl)[:-1]])
    vbase = np.concatenate([[0], np.cumsum(ns)[:-1]])

    if codec in ("vbyte", "maskedvbyte"):
        # self-delimiting: marker bits give every boundary in one scan
        marked = (
            (flat & 0x80) != 0 if codec == "vbyte" else (flat & 0x80) == 0
        )
        term = np.flatnonzero(marked)[:total]
        ends = term.astype(np.int64)
        starts = np.concatenate([[0], ends[:-1] + 1])
        all_starts = starts
        all_lens = ends - starts + 1
        group_bits = 7
    elif codec == "streamvbyte":
        group_bits = 8
        for i in range(meta.num_lists):
            n = int(ns[i])
            if n == 0:
                continue
            p = pl_base[i]
            # ctrl block then data (possibly per OPT_CHUNK chunk)
            v0 = int(vbase[i])
            done = 0
            while done < n:
                c = min(OPT_CHUNK, n - done)
                nct = (c + 3) // 4
                ctrl = flat[p : p + nct]
                codes = np.zeros(c, np.int64)
                for j in range(4):
                    sel = np.arange(j, c, 4)
                    codes[sel] = (ctrl[: sel.shape[0]] >> (2 * j)) & 3
                ln = codes + 1
                st = p + nct + np.cumsum(ln) - ln
                all_starts[v0 + done : v0 + done + c] = st
                all_lens[v0 + done : v0 + done + c] = ln
                p = p + nct + int(ln.sum())
                done += c
    elif codec == "varintgb":
        group_bits = 8
        adv_t, lens_t = blocks_mod._vgb_tables()
        for i in range(meta.num_lists):
            n = int(ns[i])
            if n == 0:
                continue
            p = int(pl_base[i])
            v0 = int(vbase[i])
            done = 0
            while done < n:
                c = min(OPT_CHUNK, n - done)
                G = (c + 3) // 4
                # bound the chain domain by the chunk's worst case
                # (17 bytes per group) — the whole remaining flat
                # buffer would make planning O(total^2)
                seg = np.concatenate(
                    [flat[p : p + 17 * G], np.zeros(8, np.uint8)]
                )
                adv = adv_t[seg[: max(seg.shape[0] - 8, 1)]]
                gpos = blocks_mod._chain_positions(adv, G)
                keys = seg[gpos]
                l4 = lens_t[keys]  # (G, 4)
                pref = np.concatenate(
                    [np.zeros((G, 1), np.int64), np.cumsum(l4, axis=1)[:, :3]],
                    axis=1,
                )
                st = (p + gpos[:, None] + 1 + pref).reshape(-1)[:c]
                ln = l4.reshape(-1)[:c]
                all_starts[v0 + done : v0 + done + c] = st
                all_lens[v0 + done : v0 + done + c] = ln
                used = c - 4 * (G - 1)
                p = int(gpos[-1]) + p + 1 + int(l4[-1, :used].sum())
                done += c
    elif codec == "varintg8iu":
        # 256-chunked; full chunks are 9-byte desc+data groups, partial
        # tails are interpolative (decoded host-side at plan time)
        group_bits = 8
        partials = []
        st_l, ln_l, oi_l = [], [], []
        for i in range(meta.num_lists):
            n = int(ns[i])
            p = int(pl_base[i])
            v0 = int(vbase[i])
            done = 0
            while done < n:
                c = min(BLOCK_SIZE, n - done)
                if c < BLOCK_SIZE:
                    vals, consumed = interpolative.decode_block(
                        flat, int(p), c, blocks_mod.UNKNOWN
                    )
                    partials.append((v0 + done, vals.astype(np.uint32)))
                    p = consumed
                    done += c
                    continue
                got = 0
                while got < c:
                    desc = int(flat[p]) ^ 0xFF  # cleared bit = value end
                    bits = [(desc >> b) & 1 for b in range(8)]
                    start = 0
                    for b in range(8):
                        if bits[b]:
                            st_l.append(p + 1 + start)
                            ln_l.append(b + 1 - start)
                            oi_l.append(v0 + done + got)
                            start = b + 1
                            got += 1
                            if got == c:
                                break
                    p += 9
                done += c
        return _byteclass_from_slices(
            codec, group_bits, flat,
            np.asarray(st_l, np.int64), np.asarray(ln_l, np.int64),
            total, np.asarray(oi_l, np.int64), partials,
        )
    else:
        raise ValueError(codec)
    return _byteclass_from_slices(
        codec, group_bits, flat, all_starts, all_lens, total
    )


def _byteclass_unpack(b: torch.Tensor, group_bits: int, salt) -> torch.Tensor:
    """(N, L) uint8 value bytes -> (N,) int32 u32 values + salt:
    little-endian groups of ``group_bits`` bits a byte (7 for the vbyte
    family: the marker bit masked off).  Assembled in int64 and wrapped
    to 32 bits (a fifth 7-bit group keeps only its low 4 bits)."""
    mask = 0xFF if group_bits == 8 else 0x7F
    v = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    for i in range(b.shape[1]):
        v |= (b[:, i].to(torch.int64) & mask) << (group_bits * i)
    return _to_i32(v & _MASK).add_(salt)


# ---------------------------------------------------------------------------
# X4: the byte-class wire unpack (csrc/byteclass_unpack.cu), one launch a run
# ---------------------------------------------------------------------------

_X4_LIB = "libdintbyte.so"
X4_MAX_CLASSES = 32
X4_VALUES_PER_BLOCK = 1024  # 256 threads, four values each


def byteclass_table(sizes: Sequence[int], lens: Sequence[int]) -> np.ndarray:
    """X4's class table without its pointers: one row of eight int64 per
    class, (src, out, N, L, block0, 0, 0, 0): class c takes
    ceil(N / X4_VALUES_PER_BLOCK) blocks of the grid from ``block0``,
    the running sum of the classes before it."""
    if len(sizes) > X4_MAX_CLASSES:
        raise ValueError(f"X4 takes at most {X4_MAX_CLASSES} classes a "
                         f"launch, got {len(sizes)}")
    t = np.zeros((len(sizes), 8), np.int64)
    block0 = 0
    for i, (N, L) in enumerate(zip(sizes, lens)):
        t[i, 2:5] = (N, L, block0)
        block0 += -(-int(N) // X4_VALUES_PER_BLOCK)
    return t


class ByteClasses:
    """The length classes of one byte-class plan as X4 decodes them:
    ``classes`` [(L, (N, L) uint8 tensor)] on one device and
    ``group_bits`` (7 or 8); their outputs ``outs`` [(N,) int32], views of
    one buffer ``buf`` (class c from ``offsets[c]``, a multiple of four
    values) allocated once and rewritten by every ``byteclass_unpack``;
    the class table.  The object holds every tensor the table points
    at."""

    def __init__(self, classes, group_bits: int, device):
        self.device = torch.empty(0, device=device).device
        if group_bits not in (7, 8):
            raise ValueError(f"byteclass_unpack: group_bits must be 7 or 8, "
                             f"got {group_bits}")
        self.group_bits = group_bits
        self.classes = [(int(L), b) for L, b in classes]
        for L, b in self.classes:
            if (b.dtype != torch.uint8 or b.device != self.device
                    or b.dim() != 2 or b.shape[1] != L or L < 1):
                raise ValueError(f"byteclass_unpack: class L={L} must be "
                                 f"(N, {L}) uint8 on {self.device}, got "
                                 f"{tuple(b.shape)} {b.dtype} on {b.device}")
            if not b.is_contiguous() or (self.device.type == "cuda"
                                         and b.data_ptr() % 4):
                raise ValueError("byteclass_unpack: every class must be "
                                 "contiguous and 4-byte aligned")
        sizes = [b.shape[0] for _, b in self.classes]
        padded = [-(-n // 4) * 4 for n in sizes]
        self.offsets = np.cumsum([0] + padded)[:-1].astype(np.int64)
        self.buf = torch.empty(sum(padded), dtype=torch.int32,
                               device=self.device)
        self.outs = [self.buf[o : o + n]
                     for o, n in zip(self.offsets.tolist(), sizes)]
        self.table = byteclass_table(sizes, [L for L, _ in self.classes])
        if self.device.type == "cuda":
            for row, (_, b), out in zip(self.table, self.classes, self.outs):
                row[:2] = (b.data_ptr(), out.data_ptr())

    def plain(self, salt: torch.Tensor) -> List[torch.Tensor]:
        """X4's plain version: ``_byteclass_unpack`` class by class."""
        s32 = _to_i32(salt.reshape(()) & _MASK)
        return [_byteclass_unpack(b, self.group_bits, s32)
                for _, b in self.classes]


def byteclass_unpack(bc: ByteClasses, salt: torch.Tensor
                     ) -> List[torch.Tensor]:
    """X4: every class of ``bc`` unpacked into ``bc.outs`` with ``salt``
    (a 1-element int64 tensor holding the u32 value) wrap-added; returns
    ``bc.outs``.  On a CUDA device this is ONE launch of
    ``dint_byteclass_unpack`` (or the call raises); on the CPU the plain
    version."""
    name = "byteclass_unpack"
    if salt.dtype != torch.int64 or salt.numel() != 1:
        raise ValueError(f"{name}: salt must be a 1-element int64 tensor")
    if salt.device != bc.device:
        raise ValueError(f"{name}: salt on {salt.device}, the classes on "
                         f"{bc.device}")
    if bc.device.type == "cpu":
        for out, got in zip(bc.outs, bc.plain(salt)):
            out.copy_(got)
        return bc.outs
    if bc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {bc.device}")
    if not any(o.numel() for o in bc.outs):
        return bc.outs
    from . import cuda_ext

    stream = torch.cuda.current_stream(bc.device).cuda_stream
    rc = cuda_ext.lib(_X4_LIB).dint_byteclass_unpack(
        bc.table.ctypes.data, bc.table.shape[0], bc.group_bits,
        salt.data_ptr(), stream)
    cuda_ext.check(_X4_LIB, "dint_byteclass_unpack", rc)
    byteclass_unpack.launches += 1
    return bc.outs


byteclass_unpack.launches = 0

KERNELS = {"X1_ladder_unpack": ladder_unpack, "X1_ladder_rows": ladder_rows,
           "X4_byteclass_unpack": byteclass_unpack}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


class ByteClassEngine:
    """Device decode of a ByteClassPlan on ``device``: every length class
    (the dense (N, L) byte arrays) in one ``byteclass_unpack`` a run, X4
    on the card."""

    def __init__(self, plan: ByteClassPlan, device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self._dev = [
            (int(L), torch.from_numpy(np.ascontiguousarray(b)).to(self.device))
            for L, b, _ in plan.classes if b.shape[0]
        ]
        self._x4 = ByteClasses(self._dev, plan.group_bits, self.device)

    def decode_classes(self) -> Dict[int, np.ndarray]:
        salt = torch.zeros((), dtype=torch.int64, device=self.device)
        outs = byteclass_unpack(self._x4, salt)
        return {L: out.cpu().numpy().view(np.uint32)
                for (L, _), out in zip(self._dev, outs)}

    def _sample_index(self) -> torch.Tensor:
        """Positions in X4's buffer of each class's first min(8, N)
        values, the chain's sample."""
        idx = [np.arange(o, o + min(8, b.shape[0]))
               for o, (_, b) in zip(self._x4.offsets, self._dev)]
        return torch.from_numpy(np.concatenate(
            idx or [np.zeros(0, np.int64)])).to(self.device)

    def chain(self, runs: int) -> torch.Tensor:
        """``runs`` decodes back to back from salt 1, every length class
        (X4's one launch) and the salted partial tails materialised each
        run; the checksum is the u32 sum of each class's first 8 values
        and of the tails, minus the salt's share, plus salt + 1, and is
        the next run's salt.  Returns it as a 0-d int64 device tensor
        holding a u32 value."""
        pvals = _u32_tensor(np.concatenate(
            [v for _, v in self.plan.partials] or [np.zeros(0, np.uint32)]
        ), self.device)
        sample = self._sample_index() if self._dev else None
        salt = torch.ones((), dtype=torch.int64, device=self.device)
        for _ in range(runs):
            s32 = _to_i32(salt)
            samples = []
            if sample is not None:
                # the chain reads its sample before the next run's launch
                # rewrites the buffer, on the same stream
                byteclass_unpack(self._x4, salt)
                samples.append(torch.index_select(self._x4.buf, 0, sample))
            samples.append(pvals + s32)
            samp = torch.cat(samples)
            total = samp.sum(dtype=torch.int32).to(torch.int64)
            salt = (total - salt * samp.numel() + salt + 1) & _MASK
        return salt

    def timed_chain(self, runs: int) -> float:
        """Seconds for ``runs`` chained decodes after a warm-up chain;
        the final checksum is kept in ``self.final_checksum``."""
        elapsed, self.final_checksum = _timed(self.chain, runs, self.device)
        return elapsed

    def decode_all_ordered(self) -> np.ndarray:
        outs = self.decode_classes()
        res = np.zeros(self.plan.total_ints, np.uint32)
        for L, b, o in self.plan.classes:
            if b.shape[0]:
                res[o] = outs[int(L)]
        for off, vals in self.plan.partials:
            res[off : off + vals.shape[0]] = vals
        return res


# ---------------------------------------------------------------------------
# Host bit unpack (optpfor's fold at load)
# ---------------------------------------------------------------------------


def _phase_geometry(b: int, vpb: int):
    """Static unpack geometry: values group by their bit phase within a
    u32 word.  Values j and j+P share shift s(j) (P = 32/gcd(b,32)), so
    each phase's fields read from STRIDED word slices — the whole
    unpack is shifts/ors over slices, no gathers and no per-bit work."""
    import math

    P = 32 // math.gcd(b, 32) if b else 1
    P_eff = min(P, vpb)
    C = vpb // P_eff  # values per phase
    stride_k = (b * P_eff) // 32  # words between consecutive same-phase values
    geo = []
    for p in range(P_eff):
        bit = p * b
        geo.append((bit // 32, bit % 32))
    return P_eff, C, stride_k, geo


def _np_phase_unpack(words: np.ndarray, b: int, vpb: int) -> np.ndarray:
    """Host phase-grouped bit unpack: (N, W) u32 payload words at width
    b -> (N, vpb) u32 values (low bits only)."""
    N = words.shape[0]
    if b == 0:
        return np.zeros((N, vpb), np.uint32)
    P_eff, C, stride_k, geo = _phase_geometry(b, vpb)
    mask = np.uint32((1 << b) - 1) if b < 32 else np.uint32(0xFFFFFFFF)
    out = np.zeros((N, vpb), np.uint32)
    for p, (k0, s) in enumerate(geo):
        end = k0 + (C - 1) * stride_k + 1 if C > 1 else k0 + 1
        w1 = words[:, k0:end:stride_k] if C > 1 else words[:, k0 : k0 + 1]
        v = (w1 >> np.uint32(s)) & mask
        if s + b > 32:
            w2 = (words[:, k0 + 1 : end + 1 : stride_k]
                  if C > 1 else words[:, k0 + 1 : k0 + 2])
            v = v | ((w2.astype(np.uint64) << np.uint64(32 - s)).astype(
                np.uint32) & mask)
        out[:, p::P_eff] = v
    return out
