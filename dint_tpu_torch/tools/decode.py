"""Vroom-equivalent decoder CLI on the card — the headline-metric harness.

Usage (mirrors vroom_env/decode.cpp:202-263):

    python -m dint_tpu_torch.tools.decode <type> <encoded_file>
        [--dict DICT_FILE] [--runs R] [--check-collection FILE]
        [--engine local|ladder|raw|device|host] [--wire]
        [--device cuda|cpu]

Loads the encoded stream + skip sidecar + dictionary, builds the serving
image (engine=local: the dictionary-gather image of the native planner,
decoded by K1-K3; engine=ladder: the canonical ladder image of the
native unit decoder, unpacked by PyTorch ops; engine=raw: the chain
scan over raw tokens, PyTorch ops), uploads it, runs one
warm-up chain of R salted runs and then R timed runs, and prints the
reference's stats record {filename, num_sequences, num_integers, type,
tot_elapsed_time, ns_x_int, ints_x_sec} (vroom_env/statistics.hpp:7-34)
plus the keys the reference package adds and the device it ran on.

The vroom zoo types (u32, vbyte, ..., pef) decode on the card through
the ladder image (``--engine device``, the default) or their
wire-structure engines (``--wire``), or on the host (``--engine host``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..backend import device_name, resolve_device
from ..codecs import encode_batch
from ..config import BLOCK_SIZE, NUM_SELECTORS
from ..dictionary.dictionary import (
    DecodeView,
    MultiPackedDictionary,
    PackedDictionary,
    RectangularDictionary,
)
from ..index import stream as stream_mod
from ..kernels import decode_local, pipeline
from . import common


@dataclass
class UnitLayout:
    """Per-decode-unit geometry derived from the skip sidecar."""

    starts: np.ndarray  # payload byte offsets (after any selector byte)
    byte_lens: np.ndarray
    n: np.ndarray
    ctx: np.ndarray
    b_bits: np.ndarray  # 16 or 8 per unit
    list_id: np.ndarray
    pos_in_list: np.ndarray  # output offset of the unit within its list


def units_from_meta(
    arena: np.ndarray, meta: stream_mod.StreamMeta, multi: bool
) -> UnitLayout:
    chunk = BLOCK_SIZE if multi else encode_batch.OPT_CHUNK
    L = meta.num_lists
    nb = ((meta.n.astype(np.int64) + chunk - 1) // chunk).clip(min=1)
    assert meta.block_ptr is not None, "stream lacks a skip sidecar"
    counts = np.diff(meta.block_ptr.astype(np.int64))
    assert (counts == nb).all(), "sidecar block counts disagree with n"
    list_id = np.repeat(np.arange(L, dtype=np.int64), nb)
    # unit index within its list
    first = np.concatenate([[0], np.cumsum(nb)[:-1]])
    unit_rank = np.arange(list_id.shape[0], dtype=np.int64) - first[list_id]
    pos_in_list = unit_rank * chunk
    n_unit = np.minimum(meta.n.astype(np.int64)[list_id] - pos_in_list, chunk)
    starts = meta.block_off.astype(np.int64).copy()
    list_end = (meta.payload_off + meta.payload_len).astype(np.int64)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:]
    ends[-1] = list_end[-1]
    # last unit of each list ends at the list's payload end
    last_of_list = np.concatenate([[0], np.cumsum(nb)])[1:] - 1
    ends[last_of_list] = list_end
    byte_lens = ends - starts
    if multi:
        sc = arena[starts].astype(np.int32)
        ctx = np.where(sc < NUM_SELECTORS, sc, sc - NUM_SELECTORS)
        b_bits = np.where(sc < NUM_SELECTORS, 16, 8)
        starts = starts + 1
        byte_lens = byte_lens - 1
    else:
        ctx = np.zeros(starts.shape[0], dtype=np.int32)
        b_bits = np.full(starts.shape[0], 16, dtype=np.int32)
    return UnitLayout(
        starts, byte_lens, n_unit.astype(np.int32), ctx.astype(np.int32),
        b_bits.astype(np.int32), list_id, pos_in_list,
    )


class StreamDecoder:
    """Device decode of a full encoded stream on ``device``.

    engine='local' (default): the serving image is planned once at load
    (native plan2, cached beside the stream in the reference package's
    .npz format) and decoded by the width-class kernels.  engine='raw':
    the general chain-scan path over raw tokens
    (``kernels/decode_xla.py`` through ``kernels/pipeline.py``, PyTorch
    ops), kept as the structure-discovering baseline."""

    ENGINES = ("local", "raw")

    def __init__(self, arena: np.ndarray, meta: stream_mod.StreamMeta,
                 view: DecodeView, multi: bool, engine: str = "local",
                 plan_cache: str = None, device="cuda"):
        if engine not in self.ENGINES:
            raise ValueError(f"engine {engine!r} not in {self.ENGINES}")
        self.device = resolve_device(device)
        self.meta = meta
        self.kind_engine = engine
        self.layout = units_from_meta(arena, meta, multi)
        lay = self.layout
        t0 = time.perf_counter()
        if engine == "raw":
            buckets = []
            for bits in (16, 8):
                m = lay.b_bits == bits
                if not m.any():
                    continue
                bks = pipeline.plan_buckets(
                    arena, lay.starts[m], lay.byte_lens[m], lay.n[m],
                    lay.ctx[m], bits,
                )
                # remap bucket indices back to global unit ids
                gids = np.flatnonzero(m)
                for bk in bks:
                    bk.indices = gids[bk.indices]
                buckets.extend(bks)
            self.engine = pipeline.DecodeEngine(view, buckets,
                                                device=self.device)
            self.plan_bytes = 0
            self._sync()
            self.cold_start_s = time.perf_counter() - t0
            return
        img_cache = (
            plan_cache.replace(".plan.", ".image.") if plan_cache else None
        )
        img = decode_local.load_image(img_cache) if img_cache else None
        if img is None:
            img = decode_local.plan_stream_image(
                arena, lay.starts, lay.byte_lens, lay.n, lay.ctx,
                lay.b_bits, view,
            )
            if img_cache:
                try:
                    decode_local.save_image(img, img_cache)
                except OSError:
                    pass
        self.engine = decode_local.ImageDecodeEngine(img, device=self.device)
        self.plan_bytes = img.device_bytes()
        self._sync()
        self.cold_start_s = time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode_all(self):
        return self.engine.decode_all()

    def timed_runs(self, runs: int) -> Tuple[float, int]:
        """(total seconds over `runs` chained full-stream decodes, ints
        per run).  Each run's salt is a u32 reduction over the previous
        run's output, so every run is distinct, fully materialized work.
        One warm-up chain first; on the card the timed chain is measured
        with CUDA events, on the CPU with the host clock.

        engine='raw': one checked pass, then ``runs`` full passes, each
        forced by fetching one element of its last tile's output to the
        host (the reference's discipline)."""
        if self.kind_engine == "raw":
            total_ints = self.engine.block_and_check(self.decode_all())

            def passes():
                for _ in range(runs):
                    outs = self.decode_all()
                    _ = int(outs[-1][0].reshape(-1)[0].item())

            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                passes()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3, total_ints
            t0 = time.perf_counter()
            passes()
            return time.perf_counter() - t0, total_ints
        total_ints = self.engine.total_ints()
        _ = int(self.engine.decode_chain(runs).item())  # warm-up
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            salt = self.engine.decode_chain(runs)
            end.record()
            end.synchronize()
            self.final_salt = int(salt.item())
            return start.elapsed_time(end) / 1e3, total_ints
        t0 = time.perf_counter()
        self.final_salt = int(self.engine.decode_chain(runs).item())
        return time.perf_counter() - t0, total_ints

    def gather_lists(self) -> List[np.ndarray]:
        """Decode and reassemble per-list int arrays (host)."""
        outs = self.decode_all()
        lay = self.layout
        lists = [np.zeros(int(n), dtype=np.uint32) for n in self.meta.n]
        if self.kind_engine == "raw":
            for uid, row, k in self.engine.iter_unit_outputs(outs):
                li = lay.list_id[uid]
                p = int(lay.pos_in_list[uid])
                lists[li][p : p + k] = row[:k]
            return lists
        units = self.engine.gather_units(outs, len(lay.starts), lay.n)
        for uid, vals in enumerate(units):
            li = lay.list_id[uid]
            p = int(lay.pos_in_list[uid])
            lists[li][p : p + vals.shape[0]] = vals
        return lists


class LadderStreamDecoder:
    """engine='ladder' for DINT streams: the canonical ladder serving
    image applied to the DINT wire format.

    The dictionary does its work at encode/storage time and at plan
    time: units host-decode ONCE at load, the flat value stream re-packs
    into 256-value blocks at no-straddle ladder widths, and the device
    decode is the broadcast shift/mask engine of
    ``kernels/unpack_device.py``.  engine='local' (the dictionary-gather
    serving image) remains the default DINT-semantics engine and the A/B
    partner.

    ``route`` picks the image build: ``"native"`` (default) is the fused
    native build, decode -> classify -> bit-pack straight to the
    lane-major class arrays with no flat intermediate, and raises if the
    native library does not build; ``"flat"`` is the native flat decode
    plus the native classify/pack; ``"numpy"`` is the numpy batch parser
    plus the numpy classify/pack, the oracle the tests compare the other
    two with."""

    ROUTES = ("native", "flat", "numpy")

    def __init__(self, arena, meta, view, multi: bool, device="cuda",
                 route: str = "native"):
        from ..kernels import unpack_device
        from ..query import native_host

        if route not in self.ROUTES:
            raise ValueError(f"route {route!r} not in {self.ROUTES}")
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.meta = meta
        lay = units_from_meta(arena, meta, multi)
        self._list_lens = np.asarray(meta.n, np.int64)
        if route == "native":
            classes, tail = native_host.decode_units_to_ladder(
                view, arena, lay.starts, lay.byte_lens, lay.n, lay.ctx,
                lay.b_bits,
            )
            plan = unpack_device.ladder_plan_prepacked(
                classes, tail, int(self._list_lens.sum()))
        elif route == "flat":
            flat = native_host.decode_units_flat(
                view, arena, lay.starts, lay.byte_lens, lay.n, lay.ctx,
                lay.b_bits,
            )
            plan = unpack_device.ladder_plan_from_values(flat)
        else:
            from ..query.lazy_decode import decode_units_fast_batch

            vals, _ = decode_units_fast_batch(
                arena, lay.starts, lay.starts + lay.byte_lens, lay.n,
                view, lay.ctx, lay.b_bits,
            )
            # units_from_meta emits units list-major and in-list
            # sequential, so unit order IS stream order
            flat = np.concatenate(vals) if vals else np.zeros(0, np.uint32)
            plan = unpack_device.ladder_plan_from_values(flat, native=False)
        self.engine = unpack_device.UnpackEngine(plan, device=self.device)
        self._plan = plan
        self.plan_bytes = self.engine.device_bytes
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.cold_start_s = time.perf_counter() - t0

    def timed_runs(self, runs: int) -> Tuple[float, int]:
        elapsed = self.engine.timed_chain(runs)
        self.final_salt = self.engine.final_checksum
        return elapsed, self._plan.total_ints

    def gather_lists(self) -> List[np.ndarray]:
        flat = self.engine.decode_all_ordered()
        cuts = np.cumsum(self._list_lens)[:-1]
        return np.split(flat, cuts)


def load_dictionary(type_name: str, dict_file: Optional[str], collection_hint=None):
    kind, policy = common.DINT_KINDS[type_name]
    if dict_file:
        if kind == "rectangular":
            return RectangularDictionary.load(dict_file)
        if kind == "multi":
            return MultiPackedDictionary.load(dict_file, policy or "pack")
        return PackedDictionary.load(dict_file, policy or "pack")
    raise ValueError("--dict required (or use the encode tool's cache file)")


def decode_stream(
    type_name: str,
    encoded_file: str,
    dict_file: Optional[str],
    runs: int = 10,
    check_collection: Optional[str] = None,
    engine: str = "local",
    device="cuda",
):
    dev = resolve_device(device)
    kind, _ = common.DINT_KINDS[type_name]
    multi = kind == "multi"
    arena, meta = stream_mod.load_stream(encoded_file)
    d = load_dictionary(type_name, dict_file)
    view = d.decode_view()
    dict_mib = (view.table.nbytes + view.offsets.nbytes) / (1 << 20)
    common.log(f"Dictionary memory: {dict_mib:.3f} [MiB]")
    plan_cache = encoded_file + f".plan.v{decode_local.PLAN_VERSION}.npz"
    if engine == "ladder":
        dec = LadderStreamDecoder(arena, meta, view, multi, dev)
    else:
        dec = StreamDecoder(arena, meta, view, multi, engine, plan_cache, dev)
    common.log(f"decoding (engine={engine}, device={device_name(dev)})...")
    elapsed, total_ints = dec.timed_runs(runs)
    per_run = elapsed / runs
    ns_x_int = per_run * 1e9 / max(total_ints, 1)
    rec = {
        "filename": encoded_file,
        "num_sequences": str(meta.num_lists),
        "num_integers": str(total_ints),
        "type": type_name,
        "tot_elapsed_time": f"{per_run}",
        "ns_x_int": f"{ns_x_int}",
        "ints_x_sec": str(int(1e9 / ns_x_int)) if ns_x_int > 0 else "inf",
        "runs": str(runs),
        "engine": engine,
        "plan_bytes": str(dec.plan_bytes),
        # time-to-first-decoded-int: one-time plan + upload wall time
        "cold_start_s": f"{dec.cold_start_s:.3f}",
    }
    img = getattr(dec.engine, "image", None)
    if img is not None:
        rec["rows"] = str(
            img.n0.shape[0] + img.n16.shape[0] + img.n32.shape[0])
        rec["geometry"] = (
            f"{decode_local.W_TOKENS}/{decode_local.N_OUT}/"
            f"{decode_local.TABLE_CLS}"
        )
    rec["device"] = device_name(dev)
    if check_collection:
        got = dec.gather_lists()
        expect, _ = common.gap_lists_of(check_collection)
        assert len(got) == len(expect), (len(got), len(expect))
        for i, (g, e) in enumerate(zip(got, expect)):
            if not np.array_equal(g, e):
                raise SystemExit(f"MISMATCH in list {i}")
        rec["check"] = "ok"
        common.log("verification ok: decoded stream matches collection")
    common.stats_line(rec)
    return rec


# zoo types with a device engine: every one through the ladder image
# (pef with per-block docid bases); WIRE_ENGINES also have a
# wire-structure engine (``wire=True``)
DEVICE_ZOO = common.VROOM_ZOO
WIRE_ENGINES = ("optpfor", "qmx", "simple16", "vbyte", "maskedvbyte",
                "streamvbyte", "varintgb", "varintg8iu")


def _expected_lists(type_name: str, check_collection: str):
    expect, _ = common.gap_lists_of(check_collection)
    if type_name == "pef":
        from ..utils import gaps as gap_mod

        expect = [gap_mod.gaps_to_docs(g) for g in expect]
    return expect


def zoo_device_engine(type_name: str, arena, meta, wire: bool = False,
                      device="cuda"):
    """(engine, plan) of a zoo stream on ``device``.  By default every
    type goes through the ladder image (``plan_ladder``: host-decode once
    at load, re-pack at no-straddle ladder widths); ``wire=True`` takes
    the wire-structure engine of the types that have one
    (``WIRE_ENGINES``): ``UnpackEngine`` for optpfor and qmx,
    ``Simple16Engine``, and ``ByteClassEngine`` for the five byte
    codecs."""
    from ..kernels import unpack_device as ud

    if type_name not in DEVICE_ZOO:
        raise ValueError(f"{type_name!r} is not a zoo type")
    if not wire or type_name not in WIRE_ENGINES:
        plan = ud.plan_ladder(type_name, arena, meta)
        return ud.UnpackEngine(plan, device=device), plan
    if type_name == "simple16":
        plan = ud.plan_simple16(arena, meta)
        return ud.Simple16Engine(plan, device=device), plan
    if type_name in ("optpfor", "qmx"):
        planner = ud.plan_optpfor if type_name == "optpfor" else ud.plan_qmx
        plan = planner(arena, meta)
        return ud.UnpackEngine(plan, device=device), plan
    plan = ud.plan_byteclass(type_name, arena, meta)
    return ud.ByteClassEngine(plan, device=device), plan


def decode_zoo_device(type_name: str, encoded_file: str, runs: int,
                      check_collection=None, wire: bool = False,
                      device="cuda"):
    """Device decode of a zoo stream (``zoo_device_engine``): ``runs``
    chained, salted runs timed after one warm-up chain, and the stats
    record; with ``check_collection`` the whole stream is decoded once
    more and compared with the collection, list for list."""
    dev = resolve_device(device)
    arena, meta = stream_mod.load_stream(encoded_file)
    common.log("planning width classes...")
    t_plan0 = time.perf_counter()
    eng, plan = zoo_device_engine(type_name, arena, meta, wire, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    cold_start_s = time.perf_counter() - t_plan0
    common.log(f"decoding (engine=device, wire={wire}, "
               f"{len(plan.classes)} classes, device={device_name(dev)})...")
    elapsed = eng.timed_chain(runs)
    total_ints = plan.total_ints
    per_run = elapsed / runs
    ns_x_int = per_run * 1e9 / max(total_ints, 1)
    rec = {
        "filename": encoded_file,
        "num_sequences": str(meta.num_lists),
        "num_integers": str(total_ints),
        "type": type_name,
        "tot_elapsed_time": f"{per_run}",
        "ns_x_int": f"{ns_x_int}",
        "ints_x_sec": str(int(1e9 / max(ns_x_int, 1e-12))),
        "runs": str(runs),
        "engine": "device",
        # the device image when the engine compiles one (ladder, folded
        # optpfor), else the wire-faithful class arrays
        "plan_bytes": str(getattr(eng, "device_bytes", 0)
                          or plan.plan_bytes()),
        "cold_start_s": f"{cold_start_s:.3f}",
        "wire": wire,
        "device": device_name(dev),
    }
    if check_collection:
        got = eng.decode_all_ordered()
        pos = 0
        for i, e in enumerate(_expected_lists(type_name, check_collection)):
            if not np.array_equal(got[pos : pos + e.shape[0]], e):
                raise SystemExit(f"MISMATCH in list {i}")
            pos += e.shape[0]
        rec["check"] = "ok"
        common.log("verification ok")
    common.stats_line(rec)
    return rec


def decode_zoo(type_name: str, encoded_file: str, runs: int,
               check_collection=None):
    """Host (numpy + native) decode of the whole-list zoo/pef types."""
    from ..index import vroom_zoo

    arena, meta = stream_mod.load_stream(encoded_file)
    total_ints = int(meta.n.astype(np.int64).sum())
    lists = [None] * meta.num_lists

    # self-delimiting byte codecs: excise every list's payload (their
    # byte lengths are sidecar state) into one contiguous buffer and
    # decode the WHOLE FILE in one vectorized pass — per-list numpy
    # fixed costs would otherwise dominate short-list collections
    offs = meta.payload_off.astype(np.int64)
    lens = meta.payload_len.astype(np.int64)
    batched_whole = (
        type_name in ("vbyte", "maskedvbyte") and meta.num_lists > 0
    )

    def one_pass():
        if batched_whole:
            from ..codecs import blocks as blocks_mod

            flat = np.concatenate(
                [arena[offs[i] : offs[i] + lens[i]]
                 for i in range(meta.num_lists)]
            )
            dec = blocks_mod.CODECS[type_name][1]
            vals, _ = dec(flat, 0, total_ints, blocks_mod.UNKNOWN)
            cuts = np.cumsum(meta.n.astype(np.int64))[:-1]
            parts = np.split(vals, cuts)
            for i in range(meta.num_lists):
                lists[i] = parts[i]
            return
        for i in range(meta.num_lists):
            n = int(meta.n[i])
            start = int(meta.payload_off[i])
            if type_name == "pef":
                lists[i] = vroom_zoo.decode_list_pef(
                    arena, start, int(meta.payload_len[i]), n,
                    int(meta.universe[i]),
                )
            else:
                lists[i] = vroom_zoo.decode_list_zoo(type_name, arena,
                                                     start, n)

    one_pass()
    t0 = time.perf_counter()
    for _ in range(runs):
        one_pass()
    t1 = time.perf_counter()
    per_run = (t1 - t0) / runs
    ns_x_int = per_run * 1e9 / max(total_ints, 1)
    rec = {
        "filename": encoded_file,
        "num_sequences": str(meta.num_lists),
        "num_integers": str(total_ints),
        "type": type_name,
        "tot_elapsed_time": f"{per_run}",
        "ns_x_int": f"{ns_x_int}",
        "ints_x_sec": str(int(1e9 / ns_x_int)),
        "runs": str(runs),
        "engine": "host",
        "device": "cpu",
    }
    if check_collection:
        for i, e in enumerate(_expected_lists(type_name, check_collection)):
            if not np.array_equal(lists[i], e):
                raise SystemExit(f"MISMATCH in list {i}")
        rec["check"] = "ok"
        common.log("verification ok")
    common.stats_line(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "type", choices=sorted(common.DINT_KINDS) + list(common.VROOM_ZOO)
    )
    ap.add_argument("encoded_file")
    ap.add_argument("--dict", dest="dict_file")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--check-collection")
    ap.add_argument(
        "--engine", choices=["local", "raw", "ladder", "device", "host"],
        default=None,
        help="DINT types: local (the dictionary-gather serving image, "
        "default) | ladder (the canonical ladder image) | raw (the "
        "chain scan over raw tokens).  Zoo types: device (default; the "
        "ladder image, or with --wire the wire-structure engine) | host "
        "(numpy and native C++)",
    )
    ap.add_argument("--wire", action="store_true",
                    help="zoo types with --engine device: decode the wire "
                    "format's own structure (" + ", ".join(WIRE_ENGINES)
                    + ") instead of the ladder image")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.type in common.VROOM_ZOO:
        engine = args.engine or "device"
        if engine == "device":
            decode_zoo_device(args.type, args.encoded_file, args.runs,
                              args.check_collection, args.wire, args.device)
        elif engine == "host":
            decode_zoo(args.type, args.encoded_file, args.runs,
                       args.check_collection)
        else:
            ap.error(f"--engine {engine} is for the DINT types")
        return
    if args.engine in ("device", "host"):
        ap.error(f"--engine {args.engine} is for the zoo types")
    decode_stream(
        args.type, args.encoded_file, args.dict_file, args.runs,
        args.check_collection, args.engine or "local", args.device,
    )


if __name__ == "__main__":
    main()
