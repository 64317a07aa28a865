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
kernel (or the call raises); nothing falls back.  The engines do not
launch the classes one by one: ``decode_classes`` covers the three
classes of a run with ONE launch (the same three bodies, a block picks
its class), raw as the class kernels write it or exact (the salt of K2
and K3 left out in the kernel); ``gather32``, ``gather16`` and ``zero``
stay as entries of their own for the ablation and the kernel checks.

Two engines run the class kernels.  ``ImageDecodeEngine`` decodes a
whole stream's packed image and keeps the reference package's
raw-output contract and its chained, salted timing protocol, so its
outputs and its chain's final salt equal ``dint_tpu``'s bit for bit.
``LocalDecodeEngine`` decodes a ``LocalPlan``: the per-unit plan of the
index query path (one 256-int block a unit), whose docids it rebuilds
with ``_docid_rebuild``, or a packed whole-stream plan
(``plan_stream(..., pack_units=True)``), with the same chain.  The
plans come from the native planner, or from the pure-Python walk
(``_plan_stream_py``) when the caller asks for it.  u32 data travels as int32 bit
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
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..backend import resolve_device
from ..config import EXCEPTIONS, MAX_ENTRY_SIZE
from ..dictionary.dictionary import DecodeView
from ..utils import trace
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
    image.  Raises when the native planner is unavailable.  Timed as the
    span ``load.plan``."""
    with trace.span("load.plan"):
        from . import planner_native

        if planner_native.get_lib() is None:
            raise RuntimeError(
                "native planner unavailable (g++ and "
                "native/dint_planner.cpp are required)"
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


# ---------------------------------------------------------------------------
# The ablation form: the whole per-row decode as one-hot products
# ---------------------------------------------------------------------------


def _onehot_dot(idx: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """out[r, q, v] = planes[r, idx[r, q], v] as a one-hot x planes
    product: idx (R, Q) in [0, D); planes (R, D, V) integers in
    [0, 255].  The planes are biased by -128 and the product's single 1
    a column adds the bias back (an index outside [0, D) gives 128).
    A float32 batched product of these operands is exact: every output
    is one plane value.  Returns (R, Q, V) float32."""
    D = planes.shape[1]
    iota = torch.arange(D, dtype=idx.dtype, device=idx.device)
    a_t = (idx[:, None, :] == iota[None, :, None]).to(torch.float32)
    p_t = (planes.transpose(1, 2) - 128).to(torch.float32)  # (R, V, D)
    return (torch.bmm(p_t, a_t) + 128).transpose(1, 2)


def _onehot_hist(bins: torch.Tensor, weights: torch.Tensor,
                 D: int) -> torch.Tensor:
    """c[r, d] = sum_q weights[r, q] * [bins[r, q] == d] as a one-hot
    product (float32, exact for the 0/1 weights of a row)."""
    iota = torch.arange(D, dtype=bins.dtype, device=bins.device)
    a = (bins[:, :, None] == iota[None, None, :]).to(torch.float32)
    return torch.bmm(weights.to(torch.float32)[:, None, :], a)[:, 0]


def _cumsum_mxu(x: torch.Tensor) -> torch.Tensor:
    """Inclusive row cumsum as int32 (the reference forms it as a
    triangular matrix product; exact either way)."""
    return torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32)


_LOCAL_ROWS_CHUNK = 256  # rows a step: the value one-hot is rows x 256 x n_out


def decode_local_rows(tokens, meta, table, n, salt=None, n_out: int = N_OUT):
    """The per-row decode of a LocalPlan without a hosted vidx: token
    metadata, the token -> output inversion and the table values are
    each gathered by a one-hot product (the reference package's ablation
    form of ``decode_local.py``).  tokens, meta (R, W) int32; table
    (R, TABLE_CLS) int32 holding u32 bits; n (R,) int32; salt (1,) int64
    holding a u32 value (or None), mixed into the table words and
    cancelled after reconstruction.  Returns (R, n_out) int32 holding
    u32 values.  Plain PyTorch on the tensors' device."""
    R, W = tokens.shape
    dev = tokens.device
    s = (salt.to(torch.int64) & _MASK if salt is not None
         else torch.zeros(1, dtype=torch.int64, device=dev))
    out = torch.empty((R, n_out), dtype=torch.int32, device=dev)
    jpos = torch.arange(n_out, dtype=torch.int32, device=dev)[None, :]
    for a in range(0, R, _LOCAL_ROWS_CHUNK):
        b = min(a + _LOCAL_ROWS_CHUNK, R)
        tok, met = tokens[a:b], meta[a:b]
        r = b - a
        # token metadata: planes [len, off_lo, off_hi]
        off_all = met & _OFF_MASK
        mplanes = torch.stack([met >> _LEN_SHIFT, off_all & 255,
                               off_all >> 8], dim=-1)  # (r, W, 3)
        tm = _onehot_dot(tok, mplanes)
        lens = tm[:, :, 0].to(torch.int32)
        offs = (tm[:, :, 1] + tm[:, :, 2] * 256.0).to(torch.int32)
        ends = _cumsum_mxu(lens)

        # invert token -> output: o_j = #tokens with end <= j, from a
        # histogram of end positions (padding tokens have len 0 and do
        # not count) and its prefix sum
        w_real = (lens > 0).to(torch.int32)
        bins = torch.clamp(ends - 1, 0, n_out - 1)
        csum = _cumsum_mxu(_onehot_hist(bins, w_real, n_out))
        o = torch.cat([torch.zeros((r, 1), dtype=torch.int32, device=dev),
                       csum[:, : n_out - 1]], dim=1)

        # per-output token attributes: planes [start_lo, start_hi,
        # off_lo, off_hi]
        starts = ends - lens
        tplanes = torch.stack([starts & 255, starts >> 8, offs & 255,
                               offs >> 8], dim=-1)  # (r, W, 4)
        ta = _onehot_dot(torch.clamp(o, max=W - 1), tplanes)
        start_o = (ta[:, :, 0] + ta[:, :, 1] * 256.0).to(torch.int32)
        off_o = (ta[:, :, 2] + ta[:, :, 3] * 256.0).to(torch.int32)
        vidx = torch.clamp(off_o + jpos - start_o, 0, TABLE_CLS - 1)

        # values: four u8 planes of the salted u32 local table
        t32 = (table[a:b].to(torch.int64) + s) & _MASK
        vplanes = torch.stack([(t32 >> (8 * k)) & 255 for k in range(4)],
                              dim=-1)  # (r, TABLE_CLS, 4)
        vv = _onehot_dot(vidx, vplanes).to(torch.int64)  # (r, n_out, 4)
        val = (vv[:, :, 0] + (vv[:, :, 1] << 8) + (vv[:, :, 2] << 16)
               + (vv[:, :, 3] << 24) - s) & _MASK
        out[a:b] = _to_i32(torch.where(jpos < n[a:b, None], val, 0))
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


def _check_gather(name, words, vidx, tab, n):
    rows = vidx.shape[0]
    if vidx.dtype != torch.uint8 or vidx.dim() != 2:
        raise ValueError(f"{name}: vidx must be (rows, n_out) uint8, got "
                         f"{tuple(vidx.shape)} {vidx.dtype}")
    if tab.dtype != torch.int32 or tuple(tab.shape) != (rows, words):
        raise ValueError(f"{name}: tab must be ({rows}, {words}) int32, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if not (vidx.device == tab.device == n.device):
        raise ValueError(f"{name}: tensors on different devices")


def _gather(name, fn, plain, words, vidx, tab, n, salt, out):
    rows, n_out = vidx.shape
    out = _check_common(name, n, salt, rows, out, n_out)
    _check_gather(name, words, vidx, tab, n)
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


def single_class_chain(vidx, tab, n, runs: int) -> torch.Tensor:
    """The reference's single-class chain (``_pallas_decode_fns``, for
    tests there): every row through K1 (``gather32``), ``runs`` salted
    decodes from salt 1, each next salt the u32 sum of the run's output
    + salt + 1.  vidx (R, N_OUT) uint8, tab (R, TABLE_CLS) int32, n (R,)
    int32; returns the final salt, a 0-d int64 tensor on their device."""
    salt = torch.ones(1, dtype=torch.int64, device=vidx.device)
    out = torch.empty(vidx.shape, dtype=torch.int32, device=vidx.device)
    for _ in range(runs):
        gather32(vidx, tab, n, salt, out)
        salt = (_u32_sum(out) + salt + 1) & _MASK
    return salt.reshape(())


def decode_classes_plain(n0, cls16, cls32, salt, exact: bool = False,
                         n_out: int = N_OUT):
    """The fused class launch in plain PyTorch: the three twins written
    into one buffer in engine order (zero, u16, i32).  ``exact`` leaves
    the salt of K2 and K3 out (their twins run with salt 0; K1's output
    does not depend on its salt)."""
    s = torch.zeros_like(salt) if exact else salt
    parts = []
    if n0 is not None and n0.shape[0]:
        parts.append(zero_plain(n0, s, n_out))
    if cls16 is not None and cls16[2].shape[0]:
        parts.append(gather16_plain(*cls16, s))
    if cls32 is not None and cls32[2].shape[0]:
        parts.append(gather32_plain(*cls32, salt))
    if not parts:
        return torch.empty((0, n_out), dtype=torch.int32, device=salt.device)
    return torch.cat(parts)


def decode_classes(n0, cls16, cls32, salt, exact: bool = False,
                   n_out: int = N_OUT, out=None):
    """One engine run over the three width classes: ``n0`` (R0,) int32 of
    the zero class, ``cls16`` and ``cls32`` the (vidx, tab, n) of the u16
    and i32 classes; a class may be None or have no rows.  Returns the
    (R0 + R16 + R32, n_out) int32 buffer in engine order (zero, u16,
    i32).  Raw (``exact`` False) is the class kernels' contract: K2 and
    K3 leave ``+ salt`` on valid lanes; ``exact`` True leaves it out.  On
    a CUDA device this is ONE launch of ``dint_decode_classes`` (or the
    call raises); on the CPU, ``decode_classes_plain``.  The call is the
    span ``decode.launch``, and on the card the library call inside it
    the span ``decode.enqueue``: a launch that waits for room in the
    card's launch queue waits there, so the launch's self time is the
    wrapper's own host cost."""
    with trace.span("decode.launch"):
        name = "decode_classes"
        dev = salt.device
        if n_out not in _N_OUT_OK:
            raise ValueError(f"{name}: n_out {n_out} not in {_N_OUT_OK}")
        if salt.dtype != torch.int64 or salt.numel() != 1:
            raise ValueError(
                f"{name}: salt must be a 1-element int64 tensor")
        # the classes that have rows, in engine order: (body, tensors)
        classes = []
        if n0 is not None and n0.shape[0]:
            classes.append(("K3_zero", (n0,)))
        for body, words, cls in (("K2_gather16", TABLE_CLS // 2, cls16),
                                 ("K1_gather32", TABLE_CLS, cls32)):
            if cls is None or cls[2].shape[0] == 0:
                continue
            _check_gather(name, words, *cls)
            if cls[0].shape[1] != n_out:
                raise ValueError(f"{name}: vidx has {cls[0].shape[1]} lanes "
                                 f"a row, n_out is {n_out}")
            classes.append((body, tuple(cls)))
        rows = {"K3_zero": 0, "K2_gather16": 0, "K1_gather32": 0}
        for body, tensors in classes:
            n = tensors[-1]
            if n.dtype != torch.int32 or n.dim() != 1 or n.device != dev:
                raise ValueError(f"{name}: n must be (rows,) int32 on {dev}, "
                                 f"got {tuple(n.shape)} {n.dtype} on "
                                 f"{n.device}")
            rows[body] = n.shape[0]
        total = sum(rows.values())
        if out is None:
            out = torch.empty((total, n_out), dtype=torch.int32, device=dev)
        elif (out.dtype != torch.int32 or tuple(out.shape) != (total, n_out)
              or out.device != dev):
            raise ValueError(f"{name}: out must be ({total}, {n_out}) int32 "
                             f"on {dev}")
        if dev.type == "cpu":
            out.copy_(decode_classes_plain(n0, cls16, cls32, salt, exact,
                                           n_out))
            return out
        if dev.type != "cuda":
            raise ValueError(f"{name}: unsupported device {dev}")
        if total == 0:
            return out
        _check_cuda(name, salt, out, *(t for _, ts in classes for t in ts))
        ptr = {body: [t.data_ptr() for t in ts] for body, ts in classes}
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = cuda_ext.lib(_LIB).dint_decode_classes
        with trace.span("decode.enqueue"):
            rc = launch(
                *ptr.get("K3_zero", [None]), rows["K3_zero"],
                *ptr.get("K2_gather16", [None] * 3), rows["K2_gather16"],
                *ptr.get("K1_gather32", [None] * 3), rows["K1_gather32"],
                salt.data_ptr(), out.data_ptr(), n_out, int(bool(exact)),
                stream,
            )
        cuda_ext.check(_LIB, "dint_decode_classes", rc)
        decode_classes.launches += 1
        for body, _ in classes:
            decode_classes.bodies[body] += 1
        return out


gather32.launches = 0
gather16.launches = 0
zero.launches = 0
decode_classes.launches = 0
# fused launches whose grid held rows of each class body
decode_classes.bodies = {"K1_gather32": 0, "K2_gather16": 0, "K3_zero": 0}

KERNELS = {"K1_gather32": gather32, "K2_gather16": gather16, "K3_zero": zero,
           "K123_decode_classes": decode_classes}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0
    for k in decode_classes.bodies:
        decode_classes.bodies[k] = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each wrapper's kernel: K1-K3 count their stand-alone
    launches only; the engines' runs count under the fused launch."""
    return {k: w.launches for k, w in KERNELS.items()}


def fused_body_counts() -> Dict[str, int]:
    """Per class body, the fused launches whose grid held rows of it."""
    return dict(decode_classes.bodies)


# ---------------------------------------------------------------------------
# Per-unit plans (the index query path)
# ---------------------------------------------------------------------------

_LEN_SHIFT = 13
_OFF_MASK = (1 << _LEN_SHIFT) - 1


@dataclass
class LocalPlan:
    """Per-unit serving plan: every unit (one 256-int block on the index
    query path) is chopped into rows of at most W_TOKENS local tokens,
    N_OUT outputs and TABLE_CLS content words, each row with its own
    local dictionary.

    Packed plans (``pack_plan_units``) hold MULTIPLE units per row; there
    unit_id/out_pos describe only each row's FIRST segment and the seg_*
    arrays carry the full row -> unit mapping.  The device kernels are
    the same either way (out[r, j] = table[r, vidx[r, j]]); only the
    host-side unit gathering differs, and only per-unit plans have one
    docid base a row (``LocalDecodeEngine.decode_docids_all``)."""

    tokens: np.ndarray  # (R, W_TOKENS) i32 local entry ids
    meta: np.ndarray  # (R, W_TOKENS) i32 len<<13|off per local id
    table: np.ndarray  # (R, TABLE_CLS) u32 local contents
    out_n: np.ndarray  # (R,) i32 ints produced per row
    unit_id: np.ndarray  # (R,) i64 unit of each row
    out_pos: np.ndarray  # (R,) i64 output offset of the row in its unit
    seg_row: np.ndarray = None  # (S,) i64 row of each segment (packed)
    seg_unit: np.ndarray = None  # (S,) i64 unit of each segment
    seg_pos: np.ndarray = None  # (S,) i64 output offset within the unit
    seg_off: np.ndarray = None  # (S,) i32 output offset within the row
    seg_len: np.ndarray = None  # (S,) i32 ints of the segment

    @property
    def rows(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def packed(self) -> bool:
        return self.seg_row is not None

    def plan_bytes(self) -> int:
        return (
            self.tokens.nbytes + self.meta.nbytes + self.table.nbytes
            + self.out_n.nbytes
        )


def _parse_unit_tokens(
    arena: np.ndarray,
    start: int,
    byte_len: int,
    n: int,
    b: int,
    view: DecodeView,
    ctx: int,
) -> Tuple[List[int], List[Tuple[int, ...]]]:
    """Walk one unit's codeword stream; return (lens, contents).

    lens[i] = ints emitted by local entry i, contents[i] its content
    tuple.
    Runs are split into 16-zero entries; exceptions become 1-int
    entries.  Clean units (no token < EXCEPTIONS) vectorize; dirty
    units take the scalar walk (rare).
    """
    tw = b // 8
    count = byte_len // tw
    base = arena[start : start + count * tw]
    if tw == 2:
        toks = base[0::2].astype(np.int64) | (base[1::2].astype(np.int64) << 8)
    else:
        toks = base.astype(np.int64)
    lengths = view.lengths[ctx]
    offsets = view.offsets[ctx]
    table = view.table

    out_lens: List[int] = []
    out_content: List[Tuple[int, ...]] = []

    if not (toks < EXCEPTIONS).any():
        # clean: every token is a codeword
        cws = toks
        lns = lengths[cws]
        for cw, ln in zip(cws, lns):
            if ln > MAX_ENTRY_SIZE:
                full, rem = divmod(int(ln), MAX_ENTRY_SIZE)
                out_lens.extend([MAX_ENTRY_SIZE] * full)
                out_content.extend([(0,) * MAX_ENTRY_SIZE] * full)
                if rem:
                    out_lens.append(rem)
                    out_content.append((0,) * rem)
            else:
                off = int(offsets[cw])
                out_lens.append(int(ln))
                out_content.append(
                    tuple(int(x) for x in table[off : off + int(ln)])
                )
    else:
        i = 0
        produced = 0
        while produced < n:
            cw = int(toks[i])
            if cw >= EXCEPTIONS:
                ln = int(lengths[cw])
                if ln > MAX_ENTRY_SIZE:
                    full, rem = divmod(ln, MAX_ENTRY_SIZE)
                    out_lens.extend([MAX_ENTRY_SIZE] * full)
                    out_content.extend([(0,) * MAX_ENTRY_SIZE] * full)
                    if rem:
                        out_lens.append(rem)
                        out_content.append((0,) * rem)
                else:
                    off = int(offsets[cw])
                    out_lens.append(ln)
                    out_content.append(
                        tuple(int(x) for x in table[off : off + ln])
                    )
                produced += ln
                i += 1
            elif cw == 1:  # 4-byte exception
                if tw == 2:
                    v = int(toks[i + 1]) | (int(toks[i + 2]) << 16)
                    i += 3
                else:
                    v = (
                        int(toks[i + 1])
                        | (int(toks[i + 2]) << 8)
                        | (int(toks[i + 3]) << 16)
                        | (int(toks[i + 4]) << 24)
                    )
                    i += 5
                out_lens.append(1)
                out_content.append((v,))
                produced += 1
            else:  # 2-byte exception
                if tw == 2:
                    v = int(toks[i + 1])
                    i += 2
                else:
                    v = int(toks[i + 1]) | (int(toks[i + 2]) << 8)
                    i += 3
                out_lens.append(1)
                out_content.append((v,))
                produced += 1
    assert sum(out_lens) == n, (sum(out_lens), n)
    return out_lens, out_content


def plan_stream(arena, starts, byte_lens, ns, ctxs, b_bits, view,
                prefer_native: bool = True,
                pack_units: bool = False) -> LocalPlan:
    """Compile all units into a LocalPlan.

    ``prefer_native`` (the default) runs the native C++ planner
    (native/dint_planner.cpp, bit-identical plans) and raises with its
    build error when it cannot be built; the pure-Python walk
    (``_plan_stream_py``) runs only when the caller passes
    ``prefer_native=False``, never in its place.  ``pack_units`` runs
    the multi-unit row-merging pass afterwards (``pack_plan_units``):
    for whole-stream decode; the index query path keeps per-unit rows,
    because the docid rebuild needs one base a row."""
    if prefer_native:
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
                f"native planner unavailable ({err.strip()}); pass "
                "prefer_native=False for the pure-Python planner walk"
            )
        plan = LocalPlan(*res)
    else:
        plan = _plan_stream_py(arena, starts, byte_lens, ns, ctxs, b_bits,
                               view)
    if pack_units:
        plan = pack_plan_units(plan)
    return plan


def _plan_stream_py(
    arena: np.ndarray,
    starts: Sequence[int],
    byte_lens: Sequence[int],
    ns: Sequence[int],
    ctxs: Sequence[int],
    b_bits: Sequence[int],
    view: DecodeView,
) -> LocalPlan:
    """Pure-Python reference planner (the oracle the native one mirrors)."""
    rows_tokens: List[np.ndarray] = []
    rows_meta: List[np.ndarray] = []
    rows_table: List[np.ndarray] = []
    rows_n: List[int] = []
    rows_unit: List[int] = []
    rows_pos: List[int] = []

    for u in range(len(starts)):
        lens, contents = _parse_unit_tokens(
            arena,
            int(starts[u]),
            int(byte_lens[u]),
            int(ns[u]),
            int(b_bits[u]),
            view,
            int(ctxs[u]),
        )
        # chop into sub-units under the three budgets
        i = 0
        out_pos = 0
        T = len(lens)
        while i < T:
            j = i
            outs = 0
            vocab: Dict[Tuple[int, ...], int] = {}
            words = MAX_ENTRY_SIZE  # leading zero region
            tok_ids: List[int] = []
            # greedy extend (token budget is implied by outs <= N_OUT
            # since every local token emits >= 1 int)
            while j < T and (j - i) < W_TOKENS and outs + lens[j] <= N_OUT:
                c = contents[j]
                if c not in vocab:
                    if all(x == 0 for x in c):
                        # zeros live in the shared leading region
                        extra = 0
                    else:
                        extra = len(c)
                    if words + extra > TABLE_CLS:
                        break
                    vocab[c] = -1  # placeholder
                    words += extra
                outs += lens[j]
                tok_ids.append(j)
                j += 1
            assert j > i, "single codeword exceeds budgets"
            # build local dict: order vocab by frequency desc
            freq: Dict[Tuple[int, ...], int] = {}
            for t in tok_ids:
                freq[contents[t]] = freq.get(contents[t], 0) + 1
            ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
            meta = np.zeros(W_TOKENS, dtype=np.int32)
            tab = np.zeros(TABLE_CLS, dtype=np.uint32)
            pos = MAX_ENTRY_SIZE
            local_id: Dict[Tuple[int, ...], int] = {}
            for vi, (c, _) in enumerate(ordered):
                local_id[c] = vi
                if all(x == 0 for x in c):
                    off = 0
                else:
                    off = pos
                    tab[pos : pos + len(c)] = c
                    pos += len(c)
                meta[vi] = np.int32((len(c) << _LEN_SHIFT) | off)
            toks = np.full(W_TOKENS, len(ordered), dtype=np.int32)
            toks[: j - i] = [local_id[contents[t]] for t in tok_ids]
            # padding id has meta 0 (len 0)
            rows_tokens.append(toks)
            rows_meta.append(meta)
            rows_table.append(tab)
            rows_n.append(outs)
            rows_unit.append(u)
            rows_pos.append(out_pos)
            out_pos += outs
            i = j

    return LocalPlan(
        np.stack(rows_tokens),
        np.stack(rows_meta),
        np.stack(rows_table),
        np.asarray(rows_n, np.int32),
        np.asarray(rows_unit, np.int64),
        np.asarray(rows_pos, np.int64),
    )


def pack_plan_units(plan: LocalPlan) -> LocalPlan:
    """Merge consecutive rows into multi-unit rows (the occupancy pass).

    Per-unit planning leaves every unit's last row partially filled,
    and a row costs the gather the same whatever it holds.  This pass
    greedily merges rows while three budgets hold — combined tokens
    <= W_TOKENS-1 (the padding id needs a meta slot), combined outputs
    <= N_OUT, combined content words <= TABLE_CLS (each row's 16-word
    leading zero region is shared) — first-fit decreasing within each
    table width class, and records a per-row SEGMENT map so
    gather_units can split merged outputs back into units.  Local
    vocabularies are concatenated without cross-row dedup (a bound, not
    a correctness issue).  The device kernels are untouched.  The
    reference's pass, row for row (held equal by a test)."""
    R = plan.rows
    if R == 0:
        return plan
    mlens = (np.take_along_axis(plan.meta, plan.tokens, axis=1)
             >> _LEN_SHIFT)
    tcount = (mlens > 0).sum(axis=1).astype(np.int64)
    vcount = ((plan.meta >> _LEN_SHIFT) > 0).sum(axis=1).astype(np.int64)
    offs = (plan.meta & _OFF_MASK).astype(np.int64)
    lens = (plan.meta >> _LEN_SHIFT).astype(np.int64)
    words = np.maximum((offs + lens).max(axis=1), MAX_ENTRY_SIZE)
    out_n = plan.out_n.astype(np.int64)
    is16 = plan.table.max(axis=1) < (1 << 16)

    # ---- first-fit-decreasing bin packing, per table-width class ----
    # (row order is free: the engine permutes rows into width classes
    # anyway and the segment map carries unit identity; packing within
    # a class keeps u16 tables u16)
    MAX_OPEN = 48  # bounded open-bin scan keeps FFD near-linear
    bins: List[List[int]] = []  # row ids per merged row
    bin_state: List[Tuple[int, int, int]] = []  # (outs, words-16 sum, toks)
    for cls in (True, False):
        rows_c = np.flatnonzero(is16 == cls)
        if rows_c.shape[0] == 0:
            continue
        order = rows_c[np.argsort(-out_n[rows_c], kind="stable")]
        open_bins: List[int] = []
        for r in order:
            o = int(out_n[r])
            w = int(words[r]) - MAX_ENTRY_SIZE
            t = int(tcount[r])
            placed = -1
            for bi in open_bins:
                bo, bw, bt = bin_state[bi]
                if bo + o <= N_OUT and bw + w <= TABLE_CLS - MAX_ENTRY_SIZE \
                        and bt + t <= W_TOKENS - 1:
                    placed = bi
                    break
            if placed < 0:
                placed = len(bins)
                bins.append([])
                bin_state.append((0, 0, 0))
                open_bins.append(placed)
            bins[placed].append(int(r))
            bo, bw, bt = bin_state[placed]
            bin_state[placed] = (bo + o, bw + w, bt + t)
            if bin_state[placed][0] > N_OUT - 8:
                open_bins.remove(placed)
            elif len(open_bins) > MAX_OPEN:
                open_bins.pop(0)

    new_tokens: List[np.ndarray] = []
    new_meta: List[np.ndarray] = []
    new_table: List[np.ndarray] = []
    new_n: List[int] = []
    seg_row: List[int] = []
    seg_unit: List[int] = []
    seg_pos: List[int] = []
    seg_off: List[int] = []
    seg_len: List[int] = []
    first_unit: List[int] = []
    first_pos: List[int] = []

    for group in bins:
        group.sort()  # stream order within the merged row
        r0 = group[0]
        cur_tok = plan.tokens[r0].copy()
        cur_meta = plan.meta[r0].copy()
        cur_tab = plan.table[r0].copy()
        cur_outs = int(out_n[r0])
        cur_words = int(words[r0])
        cur_t = int(tcount[r0])
        cur_v = int(vcount[r0])
        rid = len(new_n)
        seg_row.append(rid)
        seg_unit.append(int(plan.unit_id[r0]))
        seg_pos.append(int(plan.out_pos[r0]))
        seg_off.append(0)
        seg_len.append(cur_outs)
        for r in group[1:]:
            t, v, w, o = (
                int(tcount[r]), int(vcount[r]), int(words[r]),
                int(out_n[r]),
            )
            shift = cur_words - MAX_ENTRY_SIZE
            m = plan.meta[r, :v].astype(np.int64)
            m_off = m & _OFF_MASK
            m_len = m >> _LEN_SHIFT
            new_off = np.where(m_off == 0, 0, m_off + shift)
            cur_meta[cur_v : cur_v + v] = (
                (m_len << _LEN_SHIFT) | new_off
            ).astype(np.int32)
            cur_tok[cur_t : cur_t + t] = plan.tokens[r, :t] + cur_v
            pad_id = cur_v + v
            cur_tok[cur_t + t :] = pad_id
            cur_tab[cur_words : cur_words + (w - MAX_ENTRY_SIZE)] = (
                plan.table[r, MAX_ENTRY_SIZE : w]
            )
            seg_row.append(rid)
            seg_unit.append(int(plan.unit_id[r]))
            seg_pos.append(int(plan.out_pos[r]))
            seg_off.append(cur_outs)
            seg_len.append(o)
            cur_outs += o
            cur_words += w - MAX_ENTRY_SIZE
            cur_t += t
            cur_v += v
        new_tokens.append(cur_tok)
        new_meta.append(cur_meta)
        new_table.append(cur_tab)
        new_n.append(cur_outs)
        first_unit.append(seg_unit[-len(group)])
        first_pos.append(seg_pos[-len(group)])

    return LocalPlan(
        np.stack(new_tokens),
        np.stack(new_meta),
        np.stack(new_table),
        np.asarray(new_n, np.int32),
        np.asarray(first_unit, np.int64),
        np.asarray(first_pos, np.int64),
        np.asarray(seg_row, np.int64),
        np.asarray(seg_unit, np.int64),
        np.asarray(seg_pos, np.int64),
        np.asarray(seg_off, np.int32),
        np.asarray(seg_len, np.int32),
    )


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


def save_plan(plan: LocalPlan, path: str) -> None:
    extra = {}
    if plan.packed:
        extra = dict(
            seg_row=plan.seg_row, seg_unit=plan.seg_unit,
            seg_pos=plan.seg_pos, seg_off=plan.seg_off,
            seg_len=plan.seg_len,
        )
    np.savez(
        path,
        version=np.asarray([PLAN_VERSION, W_TOKENS, N_OUT, TABLE_CLS]),
        tokens=plan.tokens,
        meta=plan.meta,
        table=plan.table,
        out_n=plan.out_n,
        unit_id=plan.unit_id,
        out_pos=plan.out_pos,
        **extra,
    )


def load_plan(path: str):
    try:
        z = np.load(path)
        if list(z["version"]) != [PLAN_VERSION, W_TOKENS, N_OUT, TABLE_CLS]:
            return None
        segs = (
            (z["seg_row"], z["seg_unit"], z["seg_pos"], z["seg_off"],
             z["seg_len"])
            if "seg_row" in z
            else (None,) * 5
        )
        return LocalPlan(
            z["tokens"], z["meta"], z["table"], z["out_n"], z["unit_id"],
            z["out_pos"], *segs,
        )
    except Exception:
        return None


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
    i32, each padded to the row tile) and runs the class kernels' bodies
    over them, one fused launch a run (``decode_classes``) on a CUDA
    device, the plain twins on the CPU."""

    def _upload(self, parts, row_tile: int) -> None:
        """``parts``: (mode, vidx (Rc, N_OUT) u8, tab (Rc, words) u32,
        n (Rc,) i32) per class in engine order; vidx and tab are None
        for the zero class.  The padding and copies are the span
        ``load.upload`` (the copies are not waited for)."""

        def pad_rows(a, rows):
            if a.shape[0] != rows:
                ext = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
                a = np.concatenate([a, ext])
            return a

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with trace.span("load.upload"):
            self.row_tile = row_tile
            self._classes: List[_Class] = []
            base = 0
            for mode, vidx, tab, nn in parts:
                Rc = nn.shape[0]
                padded = -(-Rc // row_tile) * row_tile if Rc else 0
                c = _Class(mode, base, padded,
                           int(nn.astype(np.int64).sum()))
                if padded:
                    c.n = up(pad_rows(np.asarray(nn, np.int32), padded))
                    if mode:
                        c.vidx = up(pad_rows(np.asarray(vidx, np.uint8),
                                             padded))
                        c.tab = up(pad_rows(np.asarray(tab, np.uint32),
                                            padded).view(np.int32))
                self._classes.append(c)
                base += padded
            self.rows = base
            self._cls_bases = {c.mode: c.base for c in self._classes}
            # the fused launch writes the classes in this order
            assert [c.mode for c in self._classes] == [0, 16, 32]

    def _run(self, salt: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """Outputs of every class for one run, in one (rows, N_OUT) int32
        buffer in engine row order, from one fused launch: raw (K2 and K3
        leave ``+ salt`` on valid lanes), or exact."""
        c0, c16, c32 = self._classes
        return decode_classes(
            c0.n,
            (c16.vidx, c16.tab, c16.n) if c16.rows else None,
            (c32.vidx, c32.tab, c32.n) if c32.rows else None,
            salt, exact, N_OUT,
        )

    def _salt(self, value: int) -> torch.Tensor:
        return torch.full((1,), value & _MASK, dtype=torch.int64,
                          device=self.device)

    def decode(self, salt=0) -> torch.Tensor:
        """Exact (rows, N_OUT) output (u32 bits in int32) of one run with
        ``salt`` (an int, or a (1,) int64 device tensor holding a u32
        value, which a chain of runs never fetches): the fused launch
        leaves the salt of the u16 and zero classes out, so no pass over
        the output follows it."""
        s = salt if isinstance(salt, torch.Tensor) else self._salt(salt)
        return self._run(s, exact=True)

    def decode_all(self, salt=0) -> torch.Tensor:
        """(engine rows, N_OUT) int32 holding the u32 outputs, in engine
        row order (class-major: zero, u16, i32, each padded to the row
        tile)."""
        return self.decode(salt)

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


class ImageDecodeEngine(_ClassEngine):
    """Device runner over a DecodeImage: uploads the class arrays and
    runs them (one fused launch a run) with the reference package's
    chained, salted protocol."""

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
    """Device runner over a LocalPlan: per-unit (the index query path)
    or packed (``plan_stream(..., pack_units=True)``, whole-stream
    decode).

    The plan's rows are split into the three table width classes (zero,
    packed u16, i32), each padded to the row tile, exactly as the
    reference package's split path lays them out
    (``dint_tpu/kernels/decode_local.py:1247-1340``); the class kernels
    decode them, one fused launch a run, and ``decode_chain`` runs the
    salted chain with ``ImageDecodeEngine``'s rule.
    ``decode_docids_all`` (per-unit plans only) adds the docid
    rebuild."""

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
            assert not plan.packed, (
                "docid rebuild needs per-unit rows; plan with "
                "pack_units=False for the index path"
            )
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
        """Decode AND rebuild docids: the fused class launch, then the
        per-row prefix sum (_docid_rebuild) with hosted carries (rows of
        one unit chain through row_carry; unit_bases come from block_maxs).
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
        output (one vectorized scatter over every row, or over every
        segment of a packed plan)."""
        host = outs.cpu().numpy().view(np.uint32).reshape(-1, N_OUT)
        unit_ns = np.asarray(unit_ns, np.int64)
        unit_off = np.cumsum(unit_ns) - unit_ns
        plan = self.plan
        if plan.packed:
            rows = self._eng_of_plan[plan.seg_row]
            k = plan.seg_len.astype(np.int64)
            dst0 = unit_off[plan.seg_unit] + plan.seg_pos
            src0 = plan.seg_off.astype(np.int64)
        else:
            rows = np.flatnonzero(self.eng_unit_id >= 0)
            k = self.eng_out_n[rows].astype(np.int64)
            dst0 = unit_off[self.eng_unit_id[rows]] + self.eng_out_pos[rows]
            src0 = np.zeros(rows.shape[0], np.int64)
        first = np.cumsum(k) - k
        j = np.arange(int(k.sum()), dtype=np.int64) - np.repeat(first, k)
        flat = np.zeros(int(unit_ns.sum()), np.uint32)
        flat[np.repeat(dst0, k) + j] = host[np.repeat(rows, k),
                                            np.repeat(src0, k) + j]
        return np.split(flat, unit_off[1:])[:num_units]
