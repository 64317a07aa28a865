"""QMX: the ORIGINAL wire format (qmx.hpp), bit-true (host copy of
``dint_tpu/codecs/qmx.py``, held equal by a test).

Re-implemented from the reference's behavior (include/ds2i/qmx.hpp —
Trotman's "QMX: Quantities, Multipliers, eXtractors") and
cross-validated byte-for-byte against the reference codec compiled from
the read-only checkout (tests/test_ref_parity.py::test_qmx_*).

Format summary (all little-endian):

* Every value is assigned a QMX width in {0,1,2,3,4,5,6,7,8,9,10,12,
  16,21,32} bits — width 0 means the value IS 1 (runs of ones are
  free); value 0 costs 1 bit.
* Widths are quantized to aligned groups of 4 (group max), then a
  greedy promotion pass forces each full "instance" worth of values
  (256,128,64,40,32,24,20,36,16,28,12,20,8,12,4 values for the widths
  above, in order) to share one width, promoting a head group to the
  next width whenever a later group in the window needs more bits;
  short tails near the end of the input are promoted straight to
  8/16/32-bit byte forms.
* Values are then RLE'd into runs of equal width.  Each run is a
  sequence of instances; each batch of <= 16 instances gets one
  selector byte (width_type << 4) | (~(batch-1) & 0xF).
* Striped widths (everything except 0/8/16/32) pack an instance as 4
  interleaved lane bitstreams: value v of the instance occupies bits
  [(v//4)*w, (v//4)*w + w) of lane (v & 3), lanes being 32-bit words
  of one 128-bit word (widths 7/9/12/21 continue into a second 128-bit
  word, i.e. 64-bit lanes).  Widths 8/16/32 are plain byte/short/word
  streams clamped at the run's true value count; width 0 emits
  nothing.
* Selector bytes are appended REVERSED after the payload; the decoder
  walks them backwards from the end of the buffer.

The whole-list wrapper (vroom codecs.hpp:333-361) and the 256-block
wrapper (block_codecs.hpp:320-355) both frame the payload as
TightVariableByte(len) + payload; n == 1 lists are a bare vbyte.
"""

from __future__ import annotations

import numpy as np

# width -> (type nibble, values per instance, 128-bit words per instance)
WIDTHS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 21, 32)
_TYPE = {0: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7,
         8: 8, 9: 9, 10: 10, 12: 11, 16: 12, 21: 13, 32: 14}
_INTS = {0: 256, 1: 128, 2: 64, 3: 40, 4: 32, 5: 24, 6: 20, 7: 36,
         8: 16, 9: 28, 10: 12, 12: 20, 16: 8, 21: 12, 32: 4}
_TYPE_TO_WIDTH = {t: w for w, t in _TYPE.items()}
_NEXT = {0: 1, 1: 2, 2: 3, 3: 4, 4: 5, 5: 6, 6: 7, 7: 8, 8: 9, 9: 10,
         10: 12, 12: 16, 16: 21, 21: 32, 32: 64}
_DOUBLE = {7, 9, 12, 21}  # two 128-bit words per instance

# Lane bit offset of row k (values 4k..4k+3 of an instance).  Mostly
# k*w, but the reference's 12- and 21-bit packers place the row after
# the word-straddling one at (32 - straddle_start) instead of at the
# straddle's end, leaving unused gap bits (4 for w=12 at lane bits
# 36-39, 1 for w=21 at lane bit 42) — part of the wire format.
_ROW_SHIFTS = {w: tuple(k * w for k in range(_INTS[w] // 4)) for w in WIDTHS
               if w not in (0, 8, 16, 32)}
_ROW_SHIFTS[12] = (0, 12, 24, 40, 52)
_ROW_SHIFTS[21] = (0, 21, 43)

# bits_needed_for thresholds: value <= _THRESH[i] -> width _WBITS[i]
# (value == 1 is special-cased to width 0)
_THRESH = np.array(
    [1, 3, 7, 15, 31, 63, 127, 255, 511, 1023, 4095, 65535, 0x1FFFFF],
    dtype=np.int64,
)
_WBITS = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 16, 21, 32],
                  dtype=np.uint8)


def _widths_of(v: np.ndarray) -> np.ndarray:
    w = _WBITS[np.searchsorted(_THRESH, v.astype(np.int64), side="left")]
    w[v == 1] = 0
    return w


def _quantize_and_promote(w: np.ndarray, n: int) -> np.ndarray:
    """The reference's length-processing passes over len_buf.

    Returns the per-position widths after 4-group quantization, the
    short-tail byte-form rules, and the greedy instance promotion —
    every position's final width, so runs can be RLE'd directly.

    Vectorized form of the reference's sequential promote loop.  Key
    observation: a claim's mutations (promoting its head group,
    raising its smaller groups to the claim width) are confined to the
    claim's own consumed region, so every LATER claim decision sees
    the ORIGINAL quantized group maxima — which makes the claim width
    at any group position a pure function of sliding-window maxima:
    the smallest ladder width s whose whole instance window
    (ints(s)//4 groups) fits in s bits.  The data-dependent part
    reduces to the claim WALK (position hops), a cheap scalar loop.
    The short tails (< 16 values remaining) keep the reference's
    scalar rules verbatim.
    """
    # pad with zero-widths (the reference's WASTAGE region)
    ln = np.zeros(n + 512, dtype=np.uint8)
    ln[:n] = w
    # 4-aligned group max over [0, n+4)
    gl = n + 4 - (n + 4) % 4
    g = ln[:gl].reshape(-1, 4).max(axis=1)
    ln[:gl] = np.repeat(g, 4)

    if n >= 64:
        G = g.shape[0]
        gp = np.zeros(G + 70, dtype=np.uint8)
        gp[:G] = g  # wastage groups are zero-width, like the reference
        # smallest fitting ladder width per group position
        ok_stack = np.empty((len(WIDTHS), G), dtype=bool)
        for si, s in enumerate(WIDTHS):
            k = _INTS[s] // 4
            cur = gp.copy()
            span = 1
            while span < k:
                take = min(span, k - span)
                cur = np.maximum(cur[:-take], cur[take:])
                span += take
            ok_stack[si] = cur[:G] <= s
        first_ok = np.argmax(ok_stack, axis=0)  # WIDTHS is the ladder order
        widths_arr = np.asarray(WIDTHS, dtype=np.uint8)[first_ok]
        # claim walk: hop instance windows until the scalar-tail region
        p = 0
        gi = 0
        out_w: list = []
        out_c: list = []
        while n - p >= 16:
            s = int(widths_arr[gi])
            ints = _INTS[s]
            out_w.append(s)
            out_c.append(ints)
            p += ints
            gi += ints // 4
        if out_w:
            head = np.repeat(np.asarray(out_w, np.uint8),
                             np.asarray(out_c, np.int64))
            ln[: head.shape[0]] = head
        # restore the untouched original quantization for the tail
        # region, then run the reference's scalar rules on it
        if p < n:
            ln[p:gl] = np.repeat(g[p // 4 :], 4)
    else:
        p = 0

    while p < n:
        remaining = n - p
        if remaining < 4:
            largest = int(ln[p : p + 8].max())
            if largest <= 8:
                ln[p : p + 8] = 8
            elif largest <= 16:
                ln[p : p + 8] = 16
            elif largest <= 32:
                ln[p : p + 8] = 32
        elif remaining < 8:
            largest = int(ln[p : p + 8].max())
            if largest <= 8:
                ln[p : p + 8] = 8
            # (the reference's 16-bit arm is unreachable: its condition
            # repeats `largest <= 8` — mirrored by doing nothing here)
        elif remaining < 16:
            largest = int(ln[p : p + 16].max())
            if largest <= 8:
                ln[p : p + 16] = 8

        s = int(ln[p])
        ints = _INTS[s]
        # promote the head 4-group if any group in the instance window
        # needs more bits; otherwise claim the whole instance at s
        if s == 32:
            ln[p : p + 4] = 32
            p += 4
            continue
        window = ln[p : p + ints : 4]
        if (window > s).any():
            ln[p : p + 4] = _NEXT[s]
            continue  # re-examine at the promoted width
        ln[p : p + ints] = s
        p += ints
    return ln[:n]


def _pack_striped(vals: np.ndarray, w: int) -> bytes:
    """Pack instances of a striped width (everything but 0/8/16/32).

    vals length is a multiple of _INTS[w] (zero-padded by the caller).
    Lane layout: value v -> 64-bit lane (v & 3), bit offset (v//4)*w.
    """
    ints = _INTS[w]
    m = vals.reshape(-1, ints).astype(np.uint64)
    per_lane = ints // 4
    shifts = _ROW_SHIFTS[w]
    lanes = np.zeros((m.shape[0], 4), dtype=np.uint64)
    for k in range(per_lane):
        lanes |= m[:, 4 * k : 4 * k + 4] << np.uint64(shifts[k])
    if w in _DOUBLE:
        # two 128-bit words: lane low 32 bits first, then high 32
        out = np.empty((m.shape[0], 8), dtype="<u4")
        out[:, :4] = (lanes & np.uint64(0xFFFFFFFF)).astype("<u4")
        out[:, 4:] = (lanes >> np.uint64(32)).astype("<u4")
    else:
        out = (lanes & np.uint64(0xFFFFFFFF)).astype("<u4")
    return out.tobytes()


def encode(values, sum_of_values=None) -> bytes:
    """QMX-encode values (qmx.hpp codec::encode, byte-identical)."""
    v = np.ascontiguousarray(values, dtype="<u4")
    n = int(v.shape[0])
    if n == 0:
        return b""
    ln = _quantize_and_promote(_widths_of(v), n)

    keys = bytearray()

    # RLE over equal widths; striped runs are packed ONE batched
    # _pack_striped call per width (per-run packing of 6-byte slivers
    # measured 4x slower), then sliced back into stream order.
    bounds = np.flatnonzero(np.diff(ln.astype(np.int16))) + 1
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [n]]).astype(np.int64)
    nruns = starts.shape[0]
    parts: list = [b""] * nruns
    per_w: dict = {}
    rw = ln[starts]
    for i in range(nruns):
        st = int(starts[i])
        en = int(ends[i])
        wbits = int(rw[i])
        ints = _INTS[wbits]
        raw = en - st
        count = -(-raw // ints)  # instances
        tpe = _TYPE[wbits]
        # selector bytes, one per batch of <= 16 instances
        c = count
        while c > 0:
            batch = min(16, c)
            keys.append((tpe << 4) | (~(batch - 1) & 0x0F))
            c -= batch
        if wbits == 0:
            continue
        if wbits in (8, 16, 32):
            # plain byte/short/word stream clamped at raw values
            dt = {8: "<u1", 16: "<u2", 32: "<u4"}[wbits]
            parts[i] = v[st:en].astype(dt).tobytes()
        else:
            per_w.setdefault(wbits, []).append((i, st, en, count))
    for wbits, runs in per_w.items():
        ints = _INTS[wbits]
        wpb = (8 if wbits in _DOUBLE else 4) * 4  # bytes per instance
        tot = sum(c for _, _, _, c in runs)
        vals = np.zeros(tot * ints, dtype="<u4")
        base = 0
        for _, st, en, c in runs:
            vals[base : base + (en - st)] = v[st:en]
            base += c * ints
        packed = _pack_striped(vals, wbits)
        base = 0
        for i, _, _, c in runs:
            nb = c * wpb
            parts[i] = packed[base : base + nb]
            base += nb

    return b"".join(parts) + bytes(reversed(keys))


def _unpack_striped(words: np.ndarray, w: int, count: int) -> np.ndarray:
    """Inverse of _pack_striped: words is (count, 4 or 8) u32."""
    ints = _INTS[w]
    per_lane = ints // 4
    if w in _DOUBLE:
        lanes = words[:, :4].astype(np.uint64) | (
            words[:, 4:].astype(np.uint64) << np.uint64(32)
        )
    else:
        lanes = words.astype(np.uint64)
    out = np.empty((count, ints), dtype=np.uint32)
    mask = np.uint64((1 << w) - 1)
    for k, sh in enumerate(_ROW_SHIFTS[w]):
        out[:, 4 * k : 4 * k + 4] = (
            (lanes >> np.uint64(sh)) & mask
        ).astype(np.uint32)
    return out.reshape(-1)


def decode_payload(payload, n: int) -> np.ndarray:
    """Decode a full QMX payload (qmx.hpp codec::decode semantics) —
    native selector walk (zoo_decode.cpp zoo_qmx) with the numpy
    two-phase decode below as the cross-checked fallback."""
    from . import zoonative

    out = zoonative.qmx_decode(payload, n)
    if out is not None:
        return out
    return _decode_payload_numpy(payload, n)


def _decode_payload_numpy(payload, n: int) -> np.ndarray:
    """Decode a full QMX payload (qmx.hpp codec::decode semantics).

    Two phases: a cheap scalar walk over the (reversed, trailing)
    selector bytes establishes every run's payload offset and output
    position — byte/short/word forms clamp at the remaining output
    count, mirroring the encoder's clamped writes — then each striped
    width unpacks ALL its instances in one batched gather + static
    shift/mask pass.
    """
    data = np.frombuffer(bytes(payload), dtype=np.uint8)
    # slack: one selector byte can command 16 instances x 256 values
    out = np.empty(n + 16 * 256 + 64, dtype=np.uint32)
    # phase 1: selector walk (pure ints; one iteration per selector)
    by_width: dict = {}  # w -> ([payload_start], [out_start], [batch])
    filled = 0
    p = 0
    k = data.shape[0] - 1
    db = data.tobytes()  # plain bytes: cheap scalar indexing
    while p <= k and filled < n:
        key = db[k]
        k -= 1
        tpe = key >> 4
        low = key & 0x0F
        batch = 16 - low if low else 16
        w = _TYPE_TO_WIDTH[tpe]
        ints = _INTS[w]
        rec = by_width.setdefault(w, ([], [], []))
        rec[0].append(p)
        rec[1].append(filled)
        rec[2].append(batch)
        if w == 0:
            filled += batch * 256
        elif w in (8, 16, 32):
            take = min(batch * ints, n - filled)
            filled += take
            p += take * (w // 8)
        else:
            p += batch * (32 if w in _DOUBLE else 16)
            filled += batch * ints
    # phase 2: batched per-width unpack
    for w, (ps, os_, bs) in by_width.items():
        ps = np.asarray(ps, np.int64)
        os_ = np.asarray(os_, np.int64)
        bs = np.asarray(bs, np.int64)
        if w == 0:
            for o, b in zip(os_, bs):
                out[o : o + b * 256] = 1
            continue
        if w in (8, 16, 32):
            dt = {8: "<u1", 16: "<u2", 32: "<u4"}[w]
            nb = w // 8
            ends = np.minimum(os_ + bs * _INTS[w], n)
            for pp, o, e in zip(ps, os_, ends):
                nbytes = int(e - o) * nb
                out[o:e] = np.frombuffer(
                    db[pp : pp + nbytes], dtype=dt
                ).astype(np.uint32)
            continue
        ints = _INTS[w]
        wpw = 8 if w in _DOUBLE else 4  # u32 words per instance
        total_inst = int(bs.sum())
        # per-instance payload offsets: run start + index-in-run stride
        inst_run = np.repeat(np.arange(bs.shape[0]), bs)
        within = np.arange(total_inst) - np.repeat(
            np.cumsum(bs) - bs, bs
        )
        inst_off = ps[inst_run] + within * (wpw * 4)
        words = (
            data[inst_off[:, None] + np.arange(wpw * 4)]
            .reshape(total_inst, wpw, 4)
            .view("<u4")
            .reshape(total_inst, wpw)
        )
        vals = _unpack_striped(words, w, total_inst).reshape(
            total_inst, ints
        )
        inst_out = (os_[inst_run] + within * ints)[:, None] + np.arange(ints)
        out[inst_out.reshape(-1)] = vals.reshape(-1)
    return out[:n].copy()
