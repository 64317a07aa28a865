"""Localized decode engine on the card: the serving image and its kernels.

At stream-load time the native planner compiles the encoded stream into
a *serving image* (``DecodeImage``): per row, a byte index ``vidx`` into
a per-row local table, so the whole device decode is
``out[r, j] = table[r, vidx[r, j]]`` for ``j < n[r]``.  Rows come split
into three width classes by their table's contents:

* zero (mode 0): the table is all zero, so the row decodes to zeros;
  write-only (K3, ``zero``);
* u16 (mode 16): every table word fits 16 bits, two entries packed per
  i32 word (K2, ``gather16``);
* i32 (mode 32): the full 256-word table (K1, ``gather32``).

Each class kernel is hand-written CUDA (``csrc/decode_gather.cu``) with
a plain PyTorch twin beside it (``*_plain``).  The wrappers dispatch on
the tensors' device: a CPU tensor goes to the twin, a CUDA tensor to the
kernel (or the call raises); nothing falls back.

Two engines run the class kernels.  ``ImageDecodeEngine`` decodes a
whole stream's packed image and keeps the reference package's
raw-output contract and its chained, salted timing protocol, so its
outputs and its chain's final salt equal ``dint_tpu``'s bit for bit.
``LocalDecodeEngine`` decodes the per-unit ``LocalPlan`` of the index
query path (one 256-int block a unit, never packed across units) and
rebuilds docids with ``_docid_rebuild``.  u32 data travels as int32 bit
patterns; wrap arithmetic on it is done in int64 and masked.

Two more plain forms of the same gather live here for the kernel
ablation (``tools/kernel_ablate.py``): ``gather_flat``, the portable
plan-order decode every variant is checked against, and
``decode_gather_rows``, the one-hot matrix product that is the plain
version of K6 and K7 (``decode_pallas.py``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..backend import resolve_device
from . import cuda_ext

W_TOKENS = int(os.environ.get("DINT_TPU_W_TOKENS", "128"))  # planner chop
N_OUT = int(os.environ.get("DINT_TPU_N_OUT", "256"))  # output ints per row
if W_TOKENS <= 0:
    raise ValueError(f"DINT_TPU_W_TOKENS must be > 0, got {W_TOKENS}")
if N_OUT <= 0 or N_OUT % 128 != 0:
    raise ValueError(
        f"DINT_TPU_N_OUT must be a positive multiple of 128, got {N_OUT}")
TABLE_CLS = 256  # local table words per row (vidx values are u8)

IMAGE_VERSION = 1  # engine-ready class-array image (native plan2)
PLAN_VERSION = 3  # names the image cache file beside a stream

GATHER_ROW_TILE = 1024  # each class is padded to a multiple of this
# Chain flavor crossover: plans whose total output reaches this feed the
# next salt from the first 128 rows of each class instead of the whole
# output (the reference package's rule, kept for equal salts).
CHAIN_SUMS_MIN_OUT_BYTES = 128 * 1024 * 1024

_MASK = 0xFFFFFFFF


@dataclass
class DecodeImage:
    """Engine-ready serving image (host numpy arrays), as the native
    streaming planner (native/dint_planner.cpp plan2) produces it."""

    n0: np.ndarray  # (R0,) i32 — write-only zero-table rows
    vidx16: np.ndarray  # (R16, N_OUT) u8
    tab16: np.ndarray  # (R16, TABLE_CLS//2) u32 — 2 u16 entries/word
    n16: np.ndarray  # (R16,) i32
    vidx32: np.ndarray  # (R32, N_OUT) u8
    tab32: np.ndarray  # (R32, TABLE_CLS) u32
    n32: np.ndarray  # (R32,) i32
    seg_cls: np.ndarray  # (S,) u8 in {0, 16, 32}
    seg_row: np.ndarray  # (S,) i64 row WITHIN its class
    seg_off: np.ndarray  # (S,) i32 output offset within the row
    seg_len: np.ndarray  # (S,) i32
    seg_unit: np.ndarray  # (S,) i64 global unit id
    seg_pos: np.ndarray  # (S,) i64 output offset within the unit

    def device_bytes(self) -> int:
        return (
            self.n0.nbytes + self.vidx16.nbytes + self.tab16.nbytes
            + self.n16.nbytes + self.vidx32.nbytes + self.tab32.nbytes
            + self.n32.nbytes
        )

    def total_ints(self) -> int:
        return int(
            self.n0.astype(np.int64).sum()
            + self.n16.astype(np.int64).sum()
            + self.n32.astype(np.int64).sum()
        )


_FIELDS = tuple(f.name for f in dataclasses.fields(DecodeImage))


def image_from_numpy(fields: Dict[str, np.ndarray]) -> DecodeImage:
    """The port's image from the reference package's ``DecodeImage``
    fields (``dataclasses.asdict`` of it, or any mapping of the same
    names to arrays)."""
    missing = set(_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"image fields missing: {sorted(missing)}")
    return DecodeImage(**{k: np.asarray(fields[k]) for k in _FIELDS})


def plan_stream_image(
    arena: np.ndarray,
    starts: Sequence[int],
    byte_lens: Sequence[int],
    ns: Sequence[int],
    ctxs: Sequence[int],
    b_bits: Sequence[int],
    view,
    shard_ints: int = 32_000_000,
    threads: int = None,
) -> DecodeImage:
    """Streaming image build: units are planned in shards of about
    ``shard_ints`` output ints (native plan2 per shard), DS2I_THREADS
    shards in flight, and the shard outputs concatenate into the final
    image.  Raises when the native planner is unavailable."""
    from . import planner_native

    if planner_native.get_lib() is None:
        raise RuntimeError(
            "native planner unavailable (g++ and native/dint_planner.cpp "
            "are required)"
        )
    if threads is None:
        threads = max(1, int(os.environ.get("DS2I_THREADS", "1")))
    starts = np.ascontiguousarray(starts, np.int64)
    byte_lens = np.ascontiguousarray(byte_lens, np.int64)
    ns = np.ascontiguousarray(ns, np.int32)
    ctxs = np.ascontiguousarray(ctxs, np.int32)
    b_bits = np.ascontiguousarray(b_bits, np.int32)
    U = starts.shape[0]
    cuts = [0]
    acc = 0
    for u in range(U):
        acc += int(ns[u])
        if acc >= shard_ints:
            cuts.append(u + 1)
            acc = 0
    if cuts[-1] != U:
        cuts.append(U)
    shards = [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]

    def run_shard(a_b):
        a, b = a_b
        return planner_native.plan_shard_image(
            arena, starts[a:b], byte_lens[a:b], ns[a:b], ctxs[a:b],
            b_bits[a:b], a, view, W_TOKENS, N_OUT, TABLE_CLS,
        )

    if threads > 1 and len(shards) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(run_shard, shards))
    else:
        parts = [run_shard(s) for s in shards]
    # concatenate; seg_row offsets by per-class row bases
    b0 = b16 = b32 = 0
    seg_rows = []
    for p in parts:
        sr = p["seg_row"].copy()
        sr[p["seg_cls"] == 0] += b0
        sr[p["seg_cls"] == 16] += b16
        sr[p["seg_cls"] == 32] += b32
        seg_rows.append(sr)
        b0 += p["n0"].shape[0]
        b16 += p["n16"].shape[0]
        b32 += p["n32"].shape[0]

    def cat(key):
        return np.concatenate([p[key] for p in parts])

    fields = {k: cat(k) for k in _FIELDS if k != "seg_row"}
    fields["seg_row"] = np.concatenate(seg_rows)
    return DecodeImage(**fields)


def save_image(img: DecodeImage, path: str) -> None:
    """The reference package's ``.npz`` image format."""
    np.savez(
        path,
        image_version=np.asarray([IMAGE_VERSION, W_TOKENS, N_OUT, TABLE_CLS]),
        **{k: getattr(img, k) for k in _FIELDS},
    )


def load_image(path: str):
    """A saved image (from either package), or None if the file is
    absent, unreadable or of another version or geometry."""
    try:
        z = np.load(path)
        if "image_version" not in z:
            return None
        if list(z["image_version"]) != [
            IMAGE_VERSION, W_TOKENS, N_OUT, TABLE_CLS
        ]:
            return None
        return DecodeImage(**{k: z[k] for k in _FIELDS})
    except Exception:
        return None


# ---------------------------------------------------------------------------
# The three class kernels: plain twins and dispatching wrappers
# ---------------------------------------------------------------------------
#
# Shared arguments: vidx (R, n_out) uint8; tab (R, 256) or (R, 128) int32
# holding u32 bits; n (R,) int32; salt (1,) int64 holding a u32 value.
# Each returns (R, n_out) int32 holding the u32 raw output.


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u32_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of int32 bits as an int64 tensor, exact modulo 2^32.  The sum
    runs in int32 (wrapping): an int64 sum of an int32 tensor would
    first copy the whole tensor to int64."""
    return x.sum(dtype=torch.int32).to(torch.int64)


def _valid(n: torch.Tensor, n_out: int) -> torch.Tensor:
    jpos = torch.arange(n_out, device=n.device, dtype=torch.int32)
    return jpos[None, :] < n[:, None]


def gather32_plain(vidx, tab, n, salt):
    """K1 twin: out[r,j] = ((tab + salt)[r, vidx[r,j]]) - salt, masked."""
    s = salt.to(torch.int64) & _MASK
    t = (tab.to(torch.int64) + s) & _MASK
    val = (torch.gather(t, 1, vidx.to(torch.int64)) - s) & _MASK
    out = torch.where(_valid(n, vidx.shape[1]), val, 0)
    return _to_i32(out)


def gather16_plain(vidx, tab, n, salt):
    """K2 twin: word = tab[r, idx>>1]; val = (idx&1 ? word>>>16 : word)
    & 0xFFFF; raw = val + salt on valid lanes, 0 elsewhere."""
    s = salt.to(torch.int64) & _MASK
    idx = vidx.to(torch.int64)
    word = torch.gather(tab.to(torch.int64) & _MASK, 1, idx >> 1)
    val = torch.where((idx & 1) == 1, word >> 16, word) & 0xFFFF
    out = torch.where(_valid(n, vidx.shape[1]), (val + s) & _MASK, 0)
    return _to_i32(out)


def zero_plain(n, salt, n_out: int = N_OUT):
    """K3 twin: raw = salt on valid lanes, 0 elsewhere."""
    s = salt.to(torch.int64) & _MASK
    out = torch.where(_valid(n, n_out), s, 0)
    return _to_i32(out)


def gather_flat(vidx, table, n, salt):
    """Portable plan-order decode, the yardstick the ablation checks
    every variant against: out[r, j] = table[r, vidx[r, j] & 255] for
    j < n[r], else 0, the salt added to the table and removed again.
    vidx (R, n_out) of any integer dtype (int8 bit patterns included);
    table (R, 256) int32 holding u32 bits; returns (R, n_out) int32."""
    return gather32_plain(vidx.to(torch.int64) & 255, table, n, salt)


_ONEHOT_CHUNK = 64  # rows a step: the selector is rows x 256 x n_out words


def decode_gather_rows(vidx, table, n, salt):
    """The gather as a one-hot matrix product, in plain PyTorch: the
    plain version of K6 and K7 (``decode_pallas.py``).  The table plus
    salt is split into four byte planes biased by -128, the selector
    A[r, d, j] = [vidx[r, j] == d] picks one entry a column, the product
    accumulates in int32, and + 128, the bytes reassembled and the salt
    subtracted restore the word (u32 wrap).  A vidx outside [0, 256)
    selects nothing and gives 0x80808080 - salt.  vidx (R, n_out) int32,
    table (R, TC) int32 holding u32 bits, n (R,) int32, salt (1,) int64;
    returns (R, n_out) int32.  O(R * TC * n_out) work and memory a chunk:
    for a few hundred rows."""
    R, NO = vidx.shape
    TC = table.shape[1]
    s = salt.to(torch.int64) & _MASK
    out = torch.empty((R, NO), dtype=torch.int32, device=vidx.device)
    iota_d = torch.arange(TC, dtype=vidx.dtype, device=vidx.device)
    for a in range(0, R, _ONEHOT_CHUNK):
        b = min(a + _ONEHOT_CHUNK, R)
        t32 = (table[a:b].to(torch.int64) + s) & _MASK
        # (r, 4, TC) int32 planes in [-128, 127]; int8 x int8 products
        # would wrap in PyTorch, so the operands are widened first
        planes = torch.stack(
            [((t32 >> (8 * k)) & 255) - 128 for k in range(4)], dim=1
        ).to(torch.int32)
        sel = (vidx[a:b, None, :] == iota_d[None, :, None]).to(torch.int32)
        vv = (planes[:, :, :, None] * sel[:, None, :, :]).sum(
            dim=2, dtype=torch.int32).to(torch.int64) + 128  # (r, 4, NO)
        val = (vv[:, 0] + (vv[:, 1] << 8) + (vv[:, 2] << 16)
               + (vv[:, 3] << 24) - s) & _MASK
        out[a:b] = _to_i32(torch.where(_valid(n[a:b], NO), val, 0))
    return out


_LIB = "libdintgather.so"
_N_OUT_OK = (128, 256, 512, 1024)


def _check_common(name, n, salt, rows, out, n_out):
    dev = n.device
    if n_out not in _N_OUT_OK:
        raise ValueError(f"{name}: n_out {n_out} not in {_N_OUT_OK}")
    if n.dtype != torch.int32 or n.shape != (rows,):
        raise ValueError(f"{name}: n must be ({rows},) int32, got "
                         f"{tuple(n.shape)} {n.dtype}")
    if salt.dtype != torch.int64 or salt.numel() != 1:
        raise ValueError(f"{name}: salt must be a 1-element int64 tensor")
    if salt.device != dev:
        raise ValueError(f"{name}: salt on {salt.device}, n on {dev}")
    if out is None:
        out = torch.empty((rows, n_out), dtype=torch.int32, device=dev)
    elif (out.dtype != torch.int32 or tuple(out.shape) != (rows, n_out)
          or out.device != dev):
        raise ValueError(f"{name}: out must be ({rows}, {n_out}) int32 "
                         f"on {dev}")
    return out


def _check_cuda(name, *tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be 16-byte aligned")


def _gather(name, fn, plain, words, vidx, tab, n, salt, out):
    rows, n_out = vidx.shape
    out = _check_common(name, n, salt, rows, out, n_out)
    if vidx.dtype != torch.uint8:
        raise ValueError(f"{name}: vidx must be uint8, got {vidx.dtype}")
    if tab.dtype != torch.int32 or tuple(tab.shape) != (rows, words):
        raise ValueError(f"{name}: tab must be ({rows}, {words}) int32, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if not (vidx.device == tab.device == n.device):
        raise ValueError(f"{name}: tensors on different devices")
    if vidx.device.type == "cpu":
        out.copy_(plain(vidx, tab, n, salt))
        return out
    if vidx.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {vidx.device}")
    _check_cuda(name, vidx, tab, n, salt, out)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(vidx.device).cuda_stream
    rc = getattr(cuda_ext.lib(_LIB), fn)(
        vidx.data_ptr(), tab.data_ptr(), n.data_ptr(), salt.data_ptr(),
        out.data_ptr(), rows, n_out, stream,
    )
    cuda_ext.check(_LIB, fn, rc)
    return out


def gather32(vidx, tab, n, salt, out=None):
    """K1 (i32 class): the CUDA kernel on a CUDA tensor, the twin on a
    CPU tensor.  ``out`` (optional) receives the result in place."""
    out = _gather("gather32", "dint_gather32", gather32_plain, TABLE_CLS,
                  vidx, tab, n, salt, out)
    if out.is_cuda and out.shape[0]:
        gather32.launches += 1
    return out


def gather16(vidx, tab, n, salt, out=None):
    """K2 (packed u16 class): the CUDA kernel on a CUDA tensor, the twin
    on a CPU tensor."""
    out = _gather("gather16", "dint_gather16", gather16_plain,
                  TABLE_CLS // 2, vidx, tab, n, salt, out)
    if out.is_cuda and out.shape[0]:
        gather16.launches += 1
    return out


def zero(n, salt, n_out: int = N_OUT, out=None):
    """K3 (zero class, write-only): the CUDA kernel on a CUDA tensor,
    the twin on a CPU tensor."""
    rows = n.shape[0]
    out = _check_common("zero", n, salt, rows, out, n_out)
    if n.device.type == "cpu":
        out.copy_(zero_plain(n, salt, n_out))
        return out
    if n.device.type != "cuda":
        raise ValueError(f"zero: unsupported device {n.device}")
    _check_cuda("zero", n, salt, out)
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(n.device).cuda_stream
    rc = cuda_ext.lib(_LIB).dint_zero(
        n.data_ptr(), salt.data_ptr(), out.data_ptr(), rows, n_out, stream
    )
    cuda_ext.check(_LIB, "dint_zero", rc)
    zero.launches += 1
    return out


gather32.launches = 0
gather16.launches = 0
zero.launches = 0

KERNELS = {"K1_gather32": gather32, "K2_gather16": gather16, "K3_zero": zero}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k: w.launches for k, w in KERNELS.items()}


# ---------------------------------------------------------------------------
# Per-unit plans (the index query path)
# ---------------------------------------------------------------------------

_LEN_SHIFT = 13
_OFF_MASK = (1 << _LEN_SHIFT) - 1


@dataclass
class LocalPlan:
    """Per-unit serving plan of the index query path: every unit (one
    256-int block) is chopped into rows of at most W_TOKENS local tokens,
    N_OUT outputs and TABLE_CLS content words, each row with its own
    local dictionary.  Rows are never packed across units, so each row
    has one docid base (``LocalDecodeEngine.decode_docids_all``)."""

    tokens: np.ndarray  # (R, W_TOKENS) i32 local entry ids
    meta: np.ndarray  # (R, W_TOKENS) i32 len<<13|off per local id
    table: np.ndarray  # (R, TABLE_CLS) u32 local contents
    out_n: np.ndarray  # (R,) i32 ints produced per row
    unit_id: np.ndarray  # (R,) i64 unit of each row
    out_pos: np.ndarray  # (R,) i64 output offset of the row in its unit

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])


def plan_stream(arena, starts, byte_lens, ns, ctxs, b_bits, view) -> LocalPlan:
    """Compile the units into a per-unit LocalPlan with the native
    planner (native/dint_planner.cpp).  Raises with the build error when
    the planner cannot be built."""
    from ..utils import nativebuild
    from . import planner_native

    res = planner_native.plan_stream_native(
        arena, starts, byte_lens, ns, ctxs, b_bits, view,
        W_TOKENS, N_OUT, TABLE_CLS,
    )
    if res is None:
        err = nativebuild.errors.get("libdintplan.so",
                                     "native/dint_planner.cpp not found")
        raise RuntimeError(
            f"native planner unavailable ({err.strip()}); the pure-Python "
            "planner walk is not ported: ROADMAP.md 'Modules still to port' "
            "item 5"
        )
    return LocalPlan(*res)


def plan_to_vidx(plan: LocalPlan) -> np.ndarray:
    """Per-output-position table indices, hosted once at load:
    vidx[r, j] = off(tok_j) + j - start(tok_j), so the device decode is
    a pure table gather."""
    if plan.rows == 0:
        return np.zeros((0, N_OUT), np.int32)
    meta_pos = np.take_along_axis(plan.meta, plan.tokens, axis=1).astype(
        np.int64
    )
    lens = meta_pos >> _LEN_SHIFT
    offs = meta_pos & _OFF_MASK
    ends = np.cumsum(lens, axis=1)
    starts = ends - lens
    R = lens.shape[0]
    n = plan.out_n.astype(np.int64)
    flat_lens = lens.ravel()
    rep_off = np.repeat(offs.ravel(), flat_lens)
    rep_start = np.repeat(starts.ravel(), flat_lens)
    total = int(n.sum())
    row_base = np.concatenate([[0], np.cumsum(n)[:-1]])
    j_flat = np.arange(total, dtype=np.int64) - np.repeat(row_base, n)
    vidx = np.zeros((R, N_OUT), np.int32)
    rows_flat = np.repeat(np.arange(R, dtype=np.int64), n)
    vidx[rows_flat, j_flat] = rep_off + j_flat - rep_start
    return vidx


def _docid_rebuild(gaps: torch.Tensor, base: torch.Tensor,
                   n: torch.Tensor) -> torch.Tensor:
    """Per-row docid rebuild: docid[j] = base + cumsum(gap+1) - 1 for
    j < n, 0 elsewhere, in wrapping u32 (dict_posting_list.hpp:284-309,
    batched: each block's base comes from block_maxs).  gaps (R, N) int32
    holding u32 bits, base (R,) int64 holding u32 values, n (R,) int32;
    returns (R, N) int32 holding the u32 docids.  Torch ops on the
    tensors' device."""
    c = torch.cumsum((gaps.to(torch.int64) & _MASK) + 1, dim=1)
    doc = (base[:, None] + c - 1) & _MASK
    return _to_i32(torch.where(_valid(n, gaps.shape[1]), doc, 0))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


@dataclass
class _Class:
    mode: int  # 0, 16 or 32
    base: int  # first engine row of the class
    rows: int  # padded rows
    valid: int  # real ints of the class
    vidx: torch.Tensor = None  # (rows, N_OUT) uint8
    tab: torch.Tensor = None  # (rows, words) int32
    n: torch.Tensor = None  # (rows,) int32


def _default_row_tile(rows: int) -> int:
    return min(GATHER_ROW_TILE, max(1 << int(np.ceil(np.log2(max(rows, 1)))), 32))


class _ClassEngine:
    """Uploads the width classes (class-major engine rows: zero, u16,
    i32, each padded to the row tile) and runs the class kernels over
    them: K1-K3 on a CUDA device, their plain twins on the CPU."""

    def _upload(self, parts, row_tile: int) -> None:
        """``parts``: (mode, vidx (Rc, N_OUT) u8, tab (Rc, words) u32,
        n (Rc,) i32) per class in engine order; vidx and tab are None
        for the zero class."""

        def pad_rows(a, rows):
            if a.shape[0] != rows:
                ext = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
                a = np.concatenate([a, ext])
            return a

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.row_tile = row_tile
        self._classes: List[_Class] = []
        base = 0
        for mode, vidx, tab, nn in parts:
            Rc = nn.shape[0]
            padded = -(-Rc // row_tile) * row_tile if Rc else 0
            c = _Class(mode, base, padded, int(nn.astype(np.int64).sum()))
            if padded:
                c.n = up(pad_rows(np.asarray(nn, np.int32), padded))
                if mode:
                    c.vidx = up(pad_rows(np.asarray(vidx, np.uint8), padded))
                    c.tab = up(pad_rows(np.asarray(tab, np.uint32), padded)
                               .view(np.int32))
            self._classes.append(c)
            base += padded
        self.rows = base
        self._cls_bases = {c.mode: c.base for c in self._classes}

    def _run(self, salt: torch.Tensor) -> torch.Tensor:
        """Raw outputs of every class for one run, written into one
        (rows, N_OUT) int32 buffer in engine row order."""
        buf = torch.empty((self.rows, N_OUT), dtype=torch.int32,
                          device=self.device)
        for c in self._classes:
            if not c.rows:
                continue
            o = buf[c.base : c.base + c.rows]
            if c.mode == 0:
                zero(c.n, salt, N_OUT, out=o)
            elif c.mode == 16:
                gather16(c.vidx, c.tab, c.n, salt, out=o)
            else:
                gather32(c.vidx, c.tab, c.n, salt, out=o)
        return buf

    def _salt(self, value: int) -> torch.Tensor:
        return torch.full((1,), value & _MASK, dtype=torch.int64,
                          device=self.device)

    def decode(self, salt=0) -> torch.Tensor:
        """Exact (rows, N_OUT) output (u32 bits in int32) of one run with
        ``salt`` (an int, or a (1,) int64 device tensor holding a u32
        value, which a chain of runs never fetches): the salt the u16
        and zero classes add is removed."""
        given = isinstance(salt, torch.Tensor)
        s = salt if given else self._salt(salt)
        buf = self._run(s)
        if given or salt & _MASK:
            for c in self._classes:
                if c.rows and c.mode != 32:
                    o = buf[c.base : c.base + c.rows]
                    u = (o.to(torch.int64) - s) & _MASK
                    o.copy_(_to_i32(torch.where(_valid(c.n, N_OUT), u, 0)))
        return buf

    def decode_all(self, salt=0) -> torch.Tensor:
        """(engine rows, N_OUT) int32 holding the u32 outputs, in engine
        row order (class-major: zero, u16, i32, each padded to the row
        tile)."""
        return self.decode(salt)


class ImageDecodeEngine(_ClassEngine):
    """Device runner over a DecodeImage: uploads the class arrays and
    runs the class kernels with the reference package's chained, salted
    protocol."""

    def __init__(self, img: DecodeImage, row_tile: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.image = img
        R_max = max(img.n0.shape[0], img.n16.shape[0], img.n32.shape[0], 1)
        self._upload(
            [(0, None, None, img.n0), (16, img.vidx16, img.tab16, img.n16),
             (32, img.vidx32, img.tab32, img.n32)],
            row_tile or _default_row_tile(R_max),
        )
        self.plan_bytes = img.device_bytes()

    def total_ints(self) -> int:
        return self.image.total_ints()

    def decode_chain(self, runs: int) -> torch.Tensor:
        """Run ``runs`` salted decodes back to back, each run's salt the
        u32 sum of the previous run's output (+ salt + 1), and return the
        final salt as a 0-d int64 device tensor.  The salt stays on the
        device throughout: no run waits for the host."""
        total_out = self.rows * N_OUT * 4
        sliced = total_out >= CHAIN_SUMS_MIN_OUT_BYTES
        # whole-output flavor: next = sum(raw) - salt*V + salt + 1, with V
        # the valid ints of the salted classes; V < 2^31 keeps salt*V
        # inside int64 (the flavor only runs below 128 MiB of output)
        v_salted = sum(c.valid for c in self._classes if c.mode != 32)
        assert sliced or v_salted < 1 << 31
        salt = self._salt(1)
        for _ in range(runs):
            buf = self._run(salt)
            if sliced:
                acc = sum(
                    _u32_sum(buf[c.base : c.base + min(c.rows, 128)])
                    for c in self._classes if c.rows
                )
                nxt = acc + salt + 1
            else:
                acc = _u32_sum(buf)
                nxt = torch.add(acc, salt, alpha=1 - v_salted) + 1
            salt = nxt & _MASK
        return salt.reshape(())

    def gather_units(self, outs, num_units: int, unit_ns) -> List[np.ndarray]:
        """Per-unit u32 arrays from a decode_all output."""
        host = outs.cpu().numpy().view(np.uint32).reshape(-1, N_OUT)
        img = self.image
        res = [np.zeros(int(k), dtype=np.uint32) for k in unit_ns]
        b = self._cls_bases
        er = img.seg_row + np.where(
            img.seg_cls == 0, b[0], np.where(img.seg_cls == 16, b[16], b[32])
        )
        for s in range(img.seg_cls.shape[0]):
            u = int(img.seg_unit[s])
            p = int(img.seg_pos[s])
            o = int(img.seg_off[s])
            ln = int(img.seg_len[s])
            res[u][p : p + ln] = host[int(er[s]), o : o + ln]
        return res


class LocalDecodeEngine(_ClassEngine):
    """Device runner over a per-unit LocalPlan (the index query path).

    The plan's rows are split into the three table width classes (zero,
    packed u16, i32), each padded to the row tile, exactly as the
    reference package's split path lays them out
    (``dint_tpu/kernels/decode_local.py:1247-1340``); the class kernels
    decode them.  ``decode_docids_all`` adds the docid rebuild."""

    def __init__(self, plan: LocalPlan, row_tile: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.plan = plan
        R = plan.rows
        vidx = plan_to_vidx(plan)
        assert int(vidx.max(initial=0)) < TABLE_CLS <= 256
        vidx = vidx.astype(np.uint8)
        tabmax = plan.table.max(axis=1) if R else np.zeros(0, np.uint32)
        # all-zero tables decode to zeros whatever the tokens say: those
        # rows form the write-only zero class
        sel = {0: tabmax == 0, 16: (tabmax < (1 << 16)) & (tabmax != 0),
               32: tabmax >= (1 << 16)}
        rows_of = {m: np.flatnonzero(s) for m, s in sel.items()}
        parts = []
        for mode in (0, 16, 32):
            rows = rows_of[mode]
            tab = plan.table[rows]
            if mode == 16:
                tab = (tab[:, 0::2] | (tab[:, 1::2] << np.uint32(16))).astype(
                    np.uint32)
            parts.append((mode, vidx[rows] if mode else None,
                          tab if mode else None, plan.out_n[rows]))
        self._upload(parts, row_tile or _default_row_tile(R))
        # engine row <-> plan row maps (padding rows: unit -1, n 0)
        self.eng_unit_id = np.full(self.rows, -1, np.int64)
        self.eng_out_pos = np.zeros(self.rows, np.int64)
        self.eng_out_n = np.zeros(self.rows, np.int32)
        self._eng_of_plan = np.zeros(R, np.int64)
        for c in self._classes:
            rows = rows_of[c.mode]
            er = c.base + np.arange(rows.shape[0], dtype=np.int64)
            self._eng_of_plan[rows] = er
            self.eng_unit_id[er] = plan.unit_id[rows]
            self.eng_out_pos[er] = plan.out_pos[rows]
            self.eng_out_n[er] = plan.out_n[rows]
        self._row_carry = None

    def total_ints(self) -> int:
        return int(self.plan.out_n.astype(np.int64).sum())

    def row_carry(self) -> np.ndarray:
        """(rows,) u32: sum of (gap+1) over all PRIOR rows of the same
        unit — the docid offset each row starts at within its unit.
        Pure plan state, hosted once like vidx (host numpy)."""
        if self._row_carry is None:
            plan = self.plan
            vals = np.take_along_axis(
                plan.table, plan_to_vidx(plan), axis=1
            ).astype(np.uint64)
            jpos = np.arange(vals.shape[1])[None, :]
            valid = jpos < plan.out_n[:, None]
            s = (vals * valid).sum(axis=1).astype(np.uint64) + plan.out_n
            carry = np.zeros(plan.rows, np.uint32)
            if plan.rows:
                csum = np.cumsum(s)
                same = plan.unit_id[1:] == plan.unit_id[:-1]
                first = np.concatenate([[0], np.where(same, 0, 1)]).astype(bool)
                # exclusive prefix within unit: csum[r-1] - csum[last row
                # of previous unit]
                unit_start_csum = np.where(
                    first, np.concatenate([[0], csum[:-1]]), 0
                )
                unit_base = np.maximum.accumulate(unit_start_csum)
                carry = (
                    np.concatenate([[0], csum[:-1]]) - unit_base
                ).astype(np.uint32)
            self._row_carry = carry
        return self._row_carry

    def decode_docids_all(self, unit_bases: np.ndarray,
                          salt: int = 0) -> torch.Tensor:
        """Decode AND rebuild docids: the class kernels, then the per-row
        prefix sum (_docid_rebuild) with hosted carries (rows of one unit
        chain through row_carry; unit_bases come from block_maxs).
        Returns (engine rows, N_OUT) int32 holding u32 docids."""
        nb = (np.asarray(unit_bases, np.uint32)[self.plan.unit_id]
              .astype(np.int64) + self.row_carry()) & _MASK
        bases = np.zeros(self.rows, np.int64)
        bases[self._eng_of_plan] = nb
        gaps = self.decode(salt)
        return _docid_rebuild(
            gaps, torch.from_numpy(bases).to(self.device),
            torch.from_numpy(self.eng_out_n).to(self.device),
        )

    def gather_units(self, outs, num_units: int, unit_ns) -> List[np.ndarray]:
        """Per-unit u32 arrays from a decode_all / decode_docids_all
        output (one vectorized scatter over every row)."""
        host = outs.cpu().numpy().view(np.uint32).reshape(-1, N_OUT)
        unit_ns = np.asarray(unit_ns, np.int64)
        unit_off = np.cumsum(unit_ns) - unit_ns
        rows = np.flatnonzero(self.eng_unit_id >= 0)
        k = self.eng_out_n[rows].astype(np.int64)
        dst0 = unit_off[self.eng_unit_id[rows]] + self.eng_out_pos[rows]
        first = np.cumsum(k) - k
        j = np.arange(int(k.sum()), dtype=np.int64) - np.repeat(first, k)
        flat = np.zeros(int(unit_ns.sum()), np.uint32)
        flat[np.repeat(dst0, k) + j] = host[np.repeat(rows, k), j]
        return np.split(flat, unit_off[1:])[:num_units]
