"""Block codec zoo — the per-256-int codecs behind block_freq_index
(host copy of ``dint_tpu/codecs/blocks.py``, held equal by a test).

Capability rebuild of block_codecs.hpp's codec family (plus the QMX and
varint variants it pulls from FastPFor/streamvbyte/MaskedVByte).  Each
codec is a (encode, decode) pair over <=256-int blocks with the
reference's calling convention: known ``sum_of_values`` for docs-gap
blocks, UNKNOWN for freq blocks.  Fixed-block codecs (optpfor,
varint_G8IU) fall back to interpolative coding for partial blocks, like
the reference (block_codecs.hpp:199-203, :283-287).

Byte layouts: qmx (codecs/qmx.py), varintgb and varint_G8IU are
BYTE-IDENTICAL to the reference implementations, cross-validated
against binaries compiled from the read-only reference checkout
(tests/test_ref_parity.py); u32/vbyte/streamvbyte/maskedvbyte follow
the published formats; simple16 and optpfor are capability-equivalent
numpy designs (their originals live in the FastPFor submodule, which
is not available to validate against — round-trip exactness and
competitive sizes are the contract there).  All encoders/decoders are
numpy-vectorized.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from ..config import BLOCK_SIZE
from . import interpolative, vbyte
from . import qmx as qmx_wire
from . import zoonative

UNKNOWN = interpolative.UNKNOWN_SUM


def _as_u32(values) -> np.ndarray:
    return np.ascontiguousarray(values, dtype="<u4")


# ---------------------------------------------------------------------------
# Vectorization helpers shared by the zoo decoders.
#
# The reference implements these decode loops with unrolled SSE
# (qmx_codec.hpp, VarIntG8IU.h).  The numpy rebuild gets the same
# "many lanes at once" effect from two primitives:
#
# * _bitunpack — gather ≤5 bytes per field and shift/mask, all fields
#   at once (the fixed-width unpack behind optpfor/qmx payloads);
# * _chain_positions — materialize the data-dependent walk
#   p -> p + adv[p] (group headers whose size depends on the header
#   byte) in O(log n) rounds of gathers by jump-pointer doubling,
#   instead of a per-group Python loop.
# ---------------------------------------------------------------------------


_U8_PAD = 80  # covers qmx's worst over-read: 16 fields x 32 bits + window


def _as_u8(x) -> np.ndarray:
    """u8 array view of bytes-like or ndarray input (np.asarray would
    reject a plain ``bytes`` buffer, which remains a valid decoder
    input — the scalar fallbacks accept it, so the vectorized paths
    must too)."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return np.frombuffer(x, dtype=np.uint8)
    return np.asarray(x, dtype=np.uint8)


def _u8view(buf, pos: int, bound: int = None) -> np.ndarray:
    """u8 array of buf[pos:pos+bound] with zero padding appended.

    ``bound`` caps the view at the codec's worst-case byte count for
    the requested values — without it a 256-int block decode would
    copy (and chain-walk) the entire arena tail.  Decoders may
    speculatively read whole groups past a partial final group; the
    results are discarded, the reads must just be in bounds."""
    a = _as_u8(buf[pos : pos + bound] if bound is not None else buf[pos:])
    return np.concatenate([a, np.zeros(_U8_PAD, np.uint8)])


def _bitunpack(data: np.ndarray, bit_offsets: np.ndarray, b: int) -> np.ndarray:
    """Extract b-bit little-endian fields at arbitrary bit offsets.

    data must be padded so byte reads up to offset+5 stay in range.
    Exact for b <= 32 (windows of shift(<=7)+b <= 39 bits in 5 bytes).
    """
    if b == 0:
        return np.zeros(bit_offsets.shape[0], np.uint64)
    byte_off = (bit_offsets >> 3).astype(np.int64)
    sh = (bit_offsets & 7).astype(np.uint64)
    w = np.zeros(byte_off.shape[0], np.uint64)
    nb = (b + 7 + 7) // 8
    for i in range(nb):
        w |= data[byte_off + i].astype(np.uint64) << np.uint64(8 * i)
    return (w >> sh) & np.uint64((1 << b) - 1)


def _chain_positions(adv: np.ndarray, count: int) -> np.ndarray:
    """First `count` nodes of the walk p0=0, p_{k+1} = p_k + adv[p_k].

    Jump-pointer doubling: `jump` advances by `filled` steps at every
    round, so the node list doubles per round — O(log count) rounds of
    numpy gathers replace the sequential group walk."""
    L = adv.shape[0]
    nodes = np.zeros(count, dtype=np.int64)
    if count <= 1:
        return nodes
    jump = np.minimum(
        np.arange(L + 1, dtype=np.int32)
        + np.concatenate([adv.astype(np.int32), np.zeros(1, np.int32)]),
        np.int32(L),
    )
    filled = 1
    while filled < count:
        take = min(filled, count - filled)
        nodes[filled : filled + take] = jump[nodes[:take]]
        filled += take
        if filled < count:
            jump = jump[jump]
    return nodes


# ---------------------------------------------------------------------------
# u32 / vbyte
# ---------------------------------------------------------------------------


def u32_encode(values, sum_of_values) -> bytes:
    return _as_u32(values).tobytes()


def u32_decode(buf, pos, n, sum_of_values):
    out = np.frombuffer(bytes(buf[pos : pos + 4 * n]), dtype="<u4").copy()
    return out, pos + 4 * n


def vbyte_encode(values, sum_of_values) -> bytes:
    return vbyte.encode(_as_u32(values))


def vbyte_decode(buf, pos, n, sum_of_values):
    r = zoonative.decode("zoo_vbyte", buf, pos, n)
    if r is not None:
        return r
    return vbyte.decode(buf, pos, n)


# ---------------------------------------------------------------------------
# maskedvbyte: classic continuation-bit vbyte (MaskedVByte wire format)
# ---------------------------------------------------------------------------


def maskedvbyte_encode(values, sum_of_values) -> bytes:
    v = _as_u32(values).astype(np.uint64)
    n = v.shape[0]
    nbytes = np.ones(n, dtype=np.int64)
    for k in (7, 14, 21, 28):
        nbytes += v >= (1 << k)
    total = int(nbytes.sum())
    out = np.zeros(total, dtype=np.uint8)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    rem = v.copy()
    for b in range(5):
        m = nbytes > b
        if not m.any():
            break
        byte = (rem[m] & 0x7F).astype(np.uint8)
        more = nbytes[m] > b + 1
        byte = byte | (more.astype(np.uint8) << 7)
        out[starts[m] + b] = byte
        rem[m] >>= 7
    return out.tobytes()


def _maskedvbyte_decode_scalar(buf, pos, n, sum_of_values):
    """Byte-walk oracle (cross-checked against the vectorized decode)."""
    out = np.empty(n, dtype=np.uint32)
    p = pos
    for i in range(n):
        v = 0
        shift = 0
        while True:
            c = int(buf[p])
            p += 1
            v |= (c & 0x7F) << shift
            if not (c & 0x80):
                break
            shift += 7
        out[i] = v & 0xFFFFFFFF
    return out, p


def maskedvbyte_decode(buf, pos, n, sum_of_values):
    r = zoonative.decode("zoo_maskedvbyte", buf, pos, n)
    if r is not None:
        return r
    return _maskedvbyte_decode_numpy(buf, pos, n, sum_of_values)


def _maskedvbyte_decode_numpy(buf, pos, n, sum_of_values):
    """Vectorized, chain-free: the format is self-delimiting — a value
    ends exactly at a byte whose continuation bit is clear, so the
    first n terminator positions ARE the value boundaries (one
    flatnonzero), and bytes assemble with one masked gather per lane."""
    if n == 0:
        return np.zeros(0, np.uint32), pos
    if n <= 32:  # tiny lists: the vectorized machinery's fixed cost loses
        return _maskedvbyte_decode_scalar(buf, pos, n, sum_of_values)
    data = _u8view(buf, pos, 5 * n)
    term = np.flatnonzero((data & 0x80) == 0)
    ends = term[:n].astype(np.int64)
    starts = np.concatenate([[0], ends[:-1] + 1])
    L = ends - starts + 1
    v = np.zeros(n, np.uint64)
    for i in range(5):
        m = L > i
        if not m.any():
            break
        v[m] |= (data[starts[m] + i].astype(np.uint64) & np.uint64(0x7F)) << np.uint64(7 * i)
    end = int(ends[-1]) + 1
    return (v & np.uint64(0xFFFFFFFF)).astype(np.uint32), pos + end


# ---------------------------------------------------------------------------
# streamvbyte: 2-bit control stream + data bytes (original wire format)
# ---------------------------------------------------------------------------


def streamvbyte_encode(values, sum_of_values) -> bytes:
    v = _as_u32(values).astype(np.uint64)
    n = v.shape[0]
    lens = np.ones(n, dtype=np.int64)
    for k in (8, 16, 24):
        lens += v >= (1 << k)
    ctrl = np.zeros((n + 3) // 4, dtype=np.uint8)
    codes = (lens - 1).astype(np.uint8)
    for j in range(4):
        sel = np.arange(j, n, 4)
        ctrl[: sel.shape[0]] |= codes[sel] << (2 * j)
    data = np.zeros(int(lens.sum()), dtype=np.uint8)
    ends = np.cumsum(lens)
    starts = ends - lens
    for b in range(4):
        m = lens > b
        if not m.any():
            break
        data[starts[m] + b] = ((v[m] >> (8 * b)) & 0xFF).astype(np.uint8)
    return ctrl.tobytes() + data.tobytes()


def streamvbyte_decode(buf, pos, n, sum_of_values):
    r = zoonative.decode("zoo_streamvbyte", buf, pos, n)
    if r is not None:
        return r
    return _streamvbyte_decode_numpy(buf, pos, n, sum_of_values)


def _streamvbyte_decode_numpy(buf, pos, n, sum_of_values):
    nct = (n + 3) // 4
    ctrl = np.frombuffer(bytes(buf[pos : pos + nct]), dtype=np.uint8)
    codes = np.zeros(n, dtype=np.int64)
    for j in range(4):
        sel = np.arange(j, n, 4)
        codes[sel] = (ctrl[: sel.shape[0]] >> (2 * j)) & 3
    lens = codes + 1
    dstart = pos + nct
    total = int(lens.sum())
    data = np.frombuffer(bytes(buf[dstart : dstart + total]), dtype=np.uint8)
    ends = np.cumsum(lens)
    starts = ends - lens
    out = np.zeros(n, dtype=np.uint64)
    for b in range(4):
        m = lens > b
        if not m.any():
            break
        out[m] |= data[starts[m] + b].astype(np.uint64) << (8 * b)
    return out.astype(np.uint32), dstart + total


# ---------------------------------------------------------------------------
# varintgb: groups of 4 values, one key byte (2-bit byte-lengths)
# ---------------------------------------------------------------------------


def varintgb_encode(values, sum_of_values) -> bytes:
    v = _as_u32(values).astype(np.uint64)
    out = bytearray()
    for g in range(0, v.shape[0], 4):
        grp = v[g : g + 4]
        lens = [max(1, (int(x).bit_length() + 7) // 8) for x in grp]
        key = 0
        for j, L in enumerate(lens):
            key |= (L - 1) << (2 * j)
        out.append(key)
        for x, L in zip(grp, lens):
            out += int(x).to_bytes(L, "little")
    return bytes(out)


def _varintgb_decode_scalar(buf, pos, n, sum_of_values):
    out = np.empty(n, dtype=np.uint32)
    i = 0
    p = pos
    while i < n:
        key = int(buf[p])
        p += 1
        for j in range(min(4, n - i)):
            L = ((key >> (2 * j)) & 3) + 1
            out[i] = int.from_bytes(bytes(buf[p : p + L]), "little")
            p += L
            i += 1
    return out, p


_VGB_ADV = None  # group advance per key byte (1 + sum of 4 lengths)
_VGB_LENS = None  # (256, 4) per-slot lengths


def _vgb_tables():
    global _VGB_ADV, _VGB_LENS
    if _VGB_ADV is None:
        keys = np.arange(256, dtype=np.int64)
        lens = np.stack(
            [((keys >> (2 * j)) & 3) + 1 for j in range(4)], axis=1
        )
        _VGB_LENS = lens
        _VGB_ADV = 1 + lens.sum(axis=1)
    return _VGB_ADV, _VGB_LENS


def varintgb_decode(buf, pos, n, sum_of_values):
    r = zoonative.decode("zoo_varintgb", buf, pos, n)
    if r is not None:
        return r
    return _varintgb_decode_numpy(buf, pos, n, sum_of_values)


def _varintgb_decode_numpy(buf, pos, n, sum_of_values):
    """Vectorized: key-byte positions via the chain walk (advance is a
    pure table of the key byte), then per-slot masked byte gathers."""
    if n == 0:
        return np.zeros(0, np.uint32), pos
    if n <= 32:
        return _varintgb_decode_scalar(buf, pos, n, sum_of_values)
    adv_t, lens_t = _vgb_tables()
    G = (n + 3) // 4
    data = _u8view(buf, pos, 17 * G)
    adv = adv_t[data[: max(data.shape[0] - _U8_PAD + 1, 1)]]
    gpos = _chain_positions(adv, G)
    keys = data[gpos]
    lens = lens_t[keys]  # (G, 4)
    # byte start of slot j within group: gpos + 1 + prefix lens
    pref = np.concatenate(
        [np.zeros((G, 1), np.int64), np.cumsum(lens, axis=1)[:, :3]], axis=1
    )
    starts = gpos[:, None] + 1 + pref  # (G, 4)
    vals = np.zeros((G, 4), np.uint64)
    for b in range(4):
        m = lens > b
        vals[m] |= data[starts[m] + b].astype(np.uint64) << np.uint64(8 * b)
    out = vals.reshape(-1)[:n].astype(np.uint32)
    used = n - 4 * (G - 1)  # slots used in the last group
    end = int(gpos[-1]) + 1 + int(lens[-1, :used].sum())
    return out, pos + end


# ---------------------------------------------------------------------------
# varint_G8IU: descriptor byte + 8 data bytes per group.  Bit i of the
# descriptor is CLEARED iff data byte i ends a value (VarIntG8IU.h
# encodeBlock starts from 0xFF and XORs at end positions); unused tail
# bytes stay zero with their bits set.  Byte-identical to the reference
# class (cross-validated in tests/test_ref_parity.py).
# ---------------------------------------------------------------------------


def _varint_g8iu_encode_full(values) -> bytes:
    out = bytearray()
    i = 0
    n = len(values)
    while i < n:
        desc = 0
        data = bytearray()
        while i < n:
            x = int(values[i])
            L = max(1, (x.bit_length() + 7) // 8)
            if len(data) + L > 8:
                break
            data += x.to_bytes(L, "little")
            desc |= 1 << (len(data) - 1)
            i += 1
        data += b"\x00" * (8 - len(data))
        out.append(desc ^ 0xFF)
        out += data
    return bytes(out)


def varint_g8iu_encode(values, sum_of_values) -> bytes:
    values = _as_u32(values)
    if values.shape[0] < BLOCK_SIZE:
        return interpolative.encode_block(values, sum_of_values)
    return _varint_g8iu_encode_full(values)


def _varint_g8iu_decode_scalar(buf, pos, n, sum_of_values):
    if n < BLOCK_SIZE:
        return interpolative.decode_block(buf, pos, n, sum_of_values)
    out = np.empty(n, dtype=np.uint32)
    i = 0
    p = pos
    while i < n:
        desc = int(buf[p]) ^ 0xFF  # cleared bit = value end
        data = bytes(buf[p + 1 : p + 9])
        p += 9
        start = 0
        for b in range(8):
            if desc & (1 << b):
                out[i] = int.from_bytes(data[start : b + 1], "little")
                start = b + 1
                i += 1
                if i == n:
                    break
    return out, p


_POPCNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int64)


def varint_g8iu_decode(buf, pos, n, sum_of_values):
    if n >= BLOCK_SIZE:
        r = zoonative.decode("zoo_varintg8iu", buf, pos, n)
        if r is not None:
            return r
    return _varint_g8iu_decode_numpy(buf, pos, n, sum_of_values)


def _varint_g8iu_decode_numpy(buf, pos, n, sum_of_values):
    """Vectorized: fixed 9-byte groups (descriptor + 8 data bytes), so
    group positions are a stride — per-byte value assignment and
    in-value byte offsets come from the descriptor bits alone (the
    work VarIntG8IU.h does with one SSSE3 shuffle per group)."""
    if n < BLOCK_SIZE:
        return interpolative.decode_block(buf, pos, n, sum_of_values)
    data = _u8view(buf, pos, 9 * n)
    avail = max((data.shape[0] - _U8_PAD) // 9, 1)
    descs = data[0 : 9 * avail : 9] ^ np.uint8(0xFF)  # cleared bit = end
    cnt = _POPCNT8[descs]
    cum = np.cumsum(cnt)
    G = int(np.searchsorted(cum, n, side="left")) + 1
    descs, cnt, cum = descs[:G], cnt[:G], cum[:G]
    base = cum - cnt
    bpos = np.arange(8)
    endbits = ((descs[:, None].astype(np.int64) >> bpos) & 1).astype(np.int64)
    ends_excl = np.cumsum(endbits, axis=1) - endbits
    vidx = base[:, None] + ends_excl
    sa = np.maximum.accumulate(np.where(endbits == 1, bpos + 1, 0), axis=1)
    start_b = np.concatenate([np.zeros((G, 1), np.int64), sa[:, :7]], axis=1)
    off = bpos[None, :] - start_b
    bytes_g = data[(9 * np.arange(G, dtype=np.int64))[:, None] + 1 + bpos]
    contrib = bytes_g.astype(np.uint64) << (8 * off).astype(np.uint64)
    valid = (ends_excl < cnt[:, None]) & (vidx < n)
    out = np.zeros(n, np.uint64)
    # per byte-lane OR: within one lane every group targets a distinct
    # value (values never span groups), so fancy-assignment is safe and
    # much faster than np.add.at
    for b in range(8):
        m = valid[:, b]
        if m.any():
            out[vidx[m, b]] |= contrib[m, b]
    return out.astype(np.uint32), pos + 9 * G


# ---------------------------------------------------------------------------
# simple16: 4-bit selector + 28-bit payload words (standard mode table)
# ---------------------------------------------------------------------------

_S16_MODES = [
    (28, 1), (14, 2), (9, 3), (7, 4), (5, 5), (4, 7), (3, 9), (2, 14), (1, 28),
]
# (count, bits) canonical simple16 also has heterogeneous modes; the
# homogeneous subset is complete (1..28 bits) and keeps selection exact.


def simple16_encode(values, sum_of_values) -> bytes:
    v = _as_u32(values).astype(np.uint64)
    if (v >= (1 << 28)).any():
        raise ValueError("simple16 requires values < 2^28")
    out = np.zeros(0, dtype="<u4")
    words = []
    i = 0
    n = v.shape[0]
    while i < n:
        for mode, (cnt, bits) in enumerate(_S16_MODES):
            take = min(cnt, n - i)
            chunk = v[i : i + take]
            if (chunk < (1 << bits)).all() and (take == cnt or i + take == n):
                w = mode << 28
                for j, x in enumerate(chunk):
                    w |= int(x) << (j * bits)
                words.append(w)
                i += take
                break
        else:
            raise AssertionError("no simple16 mode matched")
    return np.asarray(words, dtype="<u4").tobytes()


def _simple16_decode_scalar(buf, pos, n, sum_of_values):
    out = np.empty(n, dtype=np.uint32)
    i = 0
    p = pos
    while i < n:
        w = int.from_bytes(bytes(buf[p : p + 4]), "little")
        p += 4
        cnt, bits = _S16_MODES[w >> 28]
        take = min(cnt, n - i)
        mask = (1 << bits) - 1
        for j in range(take):
            out[i] = (w >> (j * bits)) & mask
            i += 1
    return out, p


_S16_CNT = np.asarray([c for c, _ in _S16_MODES], np.int64)
_S16_BITS = np.asarray([b for _, b in _S16_MODES], np.int64)


def simple16_decode(buf, pos, n, sum_of_values):
    r = zoonative.decode("zoo_simple16", buf, pos, n)
    if r is not None:
        return r
    return _simple16_decode_numpy(buf, pos, n, sum_of_values)


def _simple16_decode_numpy(buf, pos, n, sum_of_values):
    """Vectorized: words sit at a fixed 4-byte stride, so all selectors
    read at once; words group by mode and each mode's fields unpack
    with pure shifts (<=28 lanes per word, vectorized across words)."""
    if n == 0:
        return np.zeros(0, np.uint32), pos
    if n <= 32:
        return _simple16_decode_scalar(buf, pos, n, sum_of_values)
    raw = _as_u8(buf[pos : pos + 4 * n])
    avail = min(raw.shape[0] // 4, n)
    words = np.frombuffer(raw[: 4 * avail].tobytes(), "<u4").astype(np.uint64)
    # clamp selectors before the table lookup: words past the true
    # stream end (cut below) may be other lists' bytes
    modes = np.minimum((words >> np.uint64(28)).astype(np.int64), 8)
    cnts = _S16_CNT[modes]
    cum = np.cumsum(cnts)
    W = int(np.searchsorted(cum, n, side="left")) + 1
    words, modes, cnts, cum = words[:W], modes[:W], cnts[:W], cum[:W]
    base = cum - cnts
    out = np.zeros(n, np.uint32)
    for mode in np.unique(modes):
        rows = np.flatnonzero(modes == mode)
        cnt, bits = int(_S16_CNT[mode]), int(_S16_BITS[mode])
        mask = np.uint64((1 << bits) - 1)
        w = words[rows]
        b0 = base[rows]
        for j in range(cnt):
            tgt = b0 + j
            m = tgt < n
            out[tgt[m]] = ((w[m] >> np.uint64(j * bits)) & mask).astype(
                np.uint32
            )
    return out, pos + 4 * W


# ---------------------------------------------------------------------------
# qmx: the ORIGINAL wire format (codecs/qmx.py, bit-true to qmx.hpp and
# cross-validated against the reference binary).  Block framing mirrors
# qmx_block (block_codecs.hpp:320-355): partial blocks divert to
# interpolative, full blocks are TightVariableByte(len) + QMX payload.
# ---------------------------------------------------------------------------


def qmx_encode(values, sum_of_values) -> bytes:
    v = _as_u32(values)
    if v.shape[0] < BLOCK_SIZE:
        return interpolative_encode(v, sum_of_values)
    payload = qmx_wire.encode(v)
    return vbyte.encode_single(len(payload)) + payload


def qmx_decode(buf, pos, n, sum_of_values):
    if n < BLOCK_SIZE:
        return interpolative_decode(buf, pos, n, sum_of_values)
    ln, pos = vbyte.decode_single(buf, pos)
    vals = qmx_wire.decode_payload(_as_u8(buf[pos : pos + ln]), n)
    return vals, pos + ln


# ---------------------------------------------------------------------------
# optpfor: PForDelta with exhaustively-optimal b (optpfor_block semantics:
# the custom findBestB tries every candidate width and keeps the
# smallest encoding, block_codecs.hpp:158-185)
# ---------------------------------------------------------------------------


def _pfd_size(v: np.ndarray, b: int) -> int:
    exc = v >= (1 << b) if b < 32 else np.zeros(v.shape, bool)
    ne = int(exc.sum())
    size = 3 + (v.shape[0] * b + 7) // 8 + ne  # header + packed + positions
    size += sum(
        max(1, (int(x >> b).bit_length() + 6) // 7) for x in v[exc]
    )
    return size


def optpfor_encode(values, sum_of_values) -> bytes:
    values = _as_u32(values)
    if values.shape[0] < BLOCK_SIZE:
        return interpolative.encode_block(values, sum_of_values)
    v = values.astype(np.uint64)
    best_b, best_sz = 32, None
    for b in range(0, 33):
        sz = _pfd_size(v, b)
        if best_sz is None or sz < best_sz:
            best_b, best_sz = b, sz
    b = best_b
    exc = v >= (1 << b) if b < 32 else np.zeros(v.shape, bool)
    epos = np.flatnonzero(exc)
    out = bytearray([b]) + len(epos).to_bytes(2, "little")
    # low b bits bit-packed
    acc = 0
    for j, x in enumerate(v & ((1 << b) - 1) if b else np.zeros_like(v)):
        acc |= int(x) << (j * b)
    out += acc.to_bytes((v.shape[0] * b + 7) // 8, "little") if b else b""
    out += bytes(int(x) for x in epos)
    for x in v[exc]:
        out += vbyte.encode_single(int(x) >> b)
    return bytes(out)


def optpfor_decode(buf, pos, n, sum_of_values):
    if n < BLOCK_SIZE:
        return interpolative.decode_block(buf, pos, n, sum_of_values)
    r = zoonative.decode("zoo_optpfor_block", buf, pos, n)
    if r is not None:
        return r
    return _optpfor_decode_numpy(buf, pos, n, sum_of_values)


def _optpfor_decode_numpy(buf, pos, n, sum_of_values):
    """Vectorized main array: one _bitunpack of n b-bit fields; the few
    exceptions patch in with a scalar vbyte walk (they are exceptions)."""
    b = int(buf[pos])
    ne = int.from_bytes(bytes(buf[pos + 1 : pos + 3]), "little")
    p = pos + 3
    nbytes = (n * b + 7) // 8
    if b:
        data = _u8view(buf, p, nbytes)
        out = _bitunpack(
            data, np.arange(n, dtype=np.int64) * b, min(b, 32)
        )
        if b > 32:  # not produced by the encoder; defensive
            out = np.zeros(n, dtype=np.uint64)
            acc = int.from_bytes(bytes(buf[p : p + nbytes]), "little")
            mask = (1 << b) - 1
            for j in range(n):
                out[j] = (acc >> (j * b)) & mask
        p += nbytes
    else:
        out = np.zeros(n, dtype=np.uint64)
    epos = _as_u8(buf[p : p + ne]).astype(np.int64)
    p += ne
    for ep in epos:
        hi, p = vbyte.decode_single(buf, p)
        out[ep] |= np.uint64(hi << b)
    return out.astype(np.uint32), p


# ---------------------------------------------------------------------------
# interpolative block codec (reference interpolative_block)
# ---------------------------------------------------------------------------


def interpolative_encode(values, sum_of_values) -> bytes:
    return interpolative.encode_block(_as_u32(values), sum_of_values)


def interpolative_decode(buf, pos, n, sum_of_values):
    return interpolative.decode_block(buf, pos, n, sum_of_values)


# registry mirroring DS2I_BLOCK_INDEX_TYPES (index_types.hpp:88-91),
# minus `mixed` which composes these (see mixed_block.py)
CODECS: Dict[str, Tuple[Callable, Callable]] = {
    "optpfor": (optpfor_encode, optpfor_decode),
    "varintg8iu": (varint_g8iu_encode, varint_g8iu_decode),
    "interpolative": (interpolative_encode, interpolative_decode),
    "qmx": (qmx_encode, qmx_decode),
    "u32": (u32_encode, u32_decode),
    "vbyte": (vbyte_encode, vbyte_decode),
    "simple16": (simple16_encode, simple16_decode),
    "varintgb": (varintgb_encode, varintgb_decode),
    "maskedvbyte": (maskedvbyte_encode, maskedvbyte_decode),
    "streamvbyte": (streamvbyte_encode, streamvbyte_decode),
}
