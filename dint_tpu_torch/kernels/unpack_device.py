"""Device bit-unpack engine: the canonical ladder serving image.

The ladder image is codec-independent: at LOAD time the stream is
host-decoded once, the flat value stream is cut into 256-value blocks,
and each block is re-packed at the smallest no-straddle ladder width
(``_LADDER``) that holds its values, so every value lives whole inside
one u32 word.  Blocks of one width form a class, stored lane-major
((W, M, 128) u32 words: word k of class row i at [k, i // 128, i % 128]).
At DECODE time each class is one broadcast shift and mask over its
words (``_fns``), with the block minimum added back for base-relative
classes (``_fns_base``).  The trailing partial block stays on the host
as plan values.

This is the ladder subset of the reference package's
``kernels/unpack_device.py`` (which has no hand-written kernel here):
the unpack runs as PyTorch ops on the engine's device.  The wire-format
engines of the other codecs (optpfor, qmx, Simple16, byte classes) and
``plan_ladder`` are not ported: ROADMAP.md 'Modules still to port'.

u32 words travel as int32 bit patterns.  ``>>`` on int32 shifts
arithmetically, but a field never crosses a word (shift + w <= 32), so
the mask after the shift removes the sign fill; at w == 32 the shift is
0 and there is no mask.  The salt is added in wrapping int32.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
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


@dataclass
class UnpackPlan:
    codec: str  # 'ladder' (the only codec ported)
    values_per_block: int
    classes: List[WidthClass]
    # host-decoded partial tails: (global output offset, values)
    partials: List[Tuple[int, np.ndarray]]
    total_ints: int

    def plan_bytes(self) -> int:
        t = 0
        for c in self.classes:
            t += c.payload.nbytes + c.out_base.nbytes
            if c.prepacked is not None:
                t += c.prepacked.nbytes
        return t


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


def _kind_fns(kind: str, b: int):
    if kind == "pforb":
        return _fns_base(b)
    return _fns(b)


class UnpackEngine:
    """Runs one ladder UnpackPlan on ``device`` (class-major outputs).

    At load the plan's classes become lane-major device images (packed
    here from the values, or shipped as they are when prepacked), so
    every width class decodes as one broadcast unpack (see _fns).
    ``device_bytes`` reports the image size; ``self._meta`` carries each
    device class's (out_base, size) block mapping."""

    def __init__(self, plan: UnpackPlan, device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        self._dev = []   # (kind, w, a0, a1) per device class
        self._meta = []  # (out_base, size) per device class
        self.device_bytes = 0
        if plan.codec != "ladder":
            raise NotImplementedError(
                f"codec {plan.codec!r}: only the ladder image is ported; "
                "the wire-format unpack engines are ROADMAP.md 'Modules "
                "still to port' item 2"
            )

        def up(a):
            a = np.ascontiguousarray(a, np.uint32).view(np.int32)
            return torch.from_numpy(a).to(self.device)

        for c in plan.classes:
            wT = up(c.prepacked if c.prepacked is not None else
                    _lane_major(_pack_w(c.payload.astype(np.uint32), c.b)))
            if c.val_base is not None:
                bT = up(_lane_major(
                    c.val_base[:, None].astype(np.uint32))[0])  # (M, 128)
                self._dev.append(("pforb", int(c.b), wT, bT))
                self.device_bytes += bT.numel() * 4
            else:
                self._dev.append(("pfor", int(c.b), wT, None))
            self._meta.append((c.out_base, c.size))
            self.device_bytes += wT.numel() * 4

    @staticmethod
    def _reorder(out: np.ndarray, n: int) -> np.ndarray:
        """(W', vpw, M, 128) class output -> (N, ints) in value order:
        value j at [j // vpw, j % vpw, i // 128, i % 128]."""
        a = np.transpose(out, (2, 3, 0, 1))
        return a.reshape(a.shape[0] * a.shape[1], -1)[:n]

    def decode_classes(self) -> List[np.ndarray]:
        salt = torch.zeros((), dtype=torch.int32, device=self.device)
        outs = []
        for (out_base, size), dev in zip(self._meta, self._dev):
            kind, b, a0, a1 = dev
            out = _kind_fns(kind, b)(a0, a1, salt)
            outs.append(self._reorder(out.cpu().numpy().view(np.uint32),
                                      out_base.shape[0]))
        return outs

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
        fns = [_kind_fns(kind, b) for kind, b, _, _ in self._dev]
        salt = torch.ones((), dtype=torch.int64, device=self.device)
        for _ in range(runs):
            s32 = _to_i32(salt)
            samples = []
            for fn, (_, _, a0, a1) in zip(fns, self._dev):
                out = fn(a0, a1, s32)
                samples.append(out[:1, :1, :8].reshape(-1))
            # partial tails are hosted plan values; per run they
            # materialize on the device like every other value
            samples.append(pvals + s32)
            samp = torch.cat(samples)
            total = samp.sum(dtype=torch.int32).to(torch.int64)
            salt = (total - salt * samp.numel()) & _MASK
        return salt

    def timed_chain(self, runs: int) -> float:
        """Seconds for ``runs`` chained full device decodes after one
        warm-up chain; the final checksum is kept in
        ``self.final_checksum``.  On the card the chain is timed with
        CUDA events, on the CPU with the host clock."""
        int(self.chain(runs).item())  # warm-up
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            final = self.chain(runs)
            end.record()
            end.synchronize()
            self.final_checksum = int(final.item())
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        self.final_checksum = int(self.chain(runs).item())
        return time.perf_counter() - t0

    def decode_all_ordered(self) -> np.ndarray:
        """Full stream decode assembled back to stream order (host
        reorder; used by the collection check)."""
        out = np.zeros(self.plan.total_ints, np.uint32)
        vpb = self.plan.values_per_block
        lanes = np.arange(vpb, dtype=np.int64)
        for (out_base, size), vals in zip(self._meta, self.decode_classes()):
            if not (np.asarray(size) == vpb).all():
                raise ValueError("a ladder class holds whole blocks only")
            out[np.asarray(out_base, np.int64)[:, None] + lanes] = \
                vals[:, :vpb]
        for off, vals in self.plan.partials:
            out[off : off + vals.shape[0]] = vals
        return out
