"""Vroom-equivalent decoder CLI on the card — the headline-metric harness.

Usage (mirrors vroom_env/decode.cpp:202-263):

    python -m dint_tpu_torch.tools.decode <type> <encoded_file>
        [--dict DICT_FILE] [--runs R] [--check-collection FILE]
        [--engine local|ladder] [--device cuda|cpu]

Loads the encoded stream + skip sidecar + dictionary, builds the serving
image (engine=local: the dictionary-gather image of the native planner,
decoded by K1-K3; engine=ladder: the canonical ladder image of the
native unit decoder, unpacked by PyTorch ops), uploads it, runs one
warm-up chain of R salted runs and then R timed runs, and prints the
reference's stats record {filename, num_sequences, num_integers, type,
tot_elapsed_time, ns_x_int, ints_x_sec} (vroom_env/statistics.hpp:7-34)
plus the keys the reference package adds and the device it ran on.
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
from ..kernels import decode_local
from . import common

_NOT_PORTED = {
    "raw": "ROADMAP.md 'Modules still to port' item 2 (the raw chain-scan "
           "engine, kernels/decode_xla.py + kernels/pipeline.py)",
}


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
    """Device decode of a full encoded stream (engine='local'): the
    serving image is planned once at load (native plan2, cached beside
    the stream in the reference package's .npz format) and decoded by
    the width-class kernels on ``device``."""

    def __init__(self, arena: np.ndarray, meta: stream_mod.StreamMeta,
                 view: DecodeView, multi: bool, engine: str = "local",
                 plan_cache: str = None, device="cuda"):
        if engine != "local":
            raise NotImplementedError(
                f"engine={engine!r} is not ported yet: "
                f"{_NOT_PORTED.get(engine, 'unknown engine')}"
            )
        self.device = resolve_device(device)
        self.meta = meta
        self.layout = units_from_meta(arena, meta, multi)
        lay = self.layout
        t0 = time.perf_counter()
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.cold_start_s = time.perf_counter() - t0

    def decode_all(self):
        return self.engine.decode_all()

    def timed_runs(self, runs: int) -> Tuple[float, int]:
        """(total seconds over `runs` chained full-stream decodes, ints
        per run).  Each run's salt is a u32 reduction over the previous
        run's output, so every run is distinct, fully materialized work.
        One warm-up chain first; on the card the timed chain is measured
        with CUDA events, on the CPU with the host clock."""
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
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet: {_NOT_PORTED[engine]}"
        )
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("type", choices=sorted(common.DINT_KINDS))
    ap.add_argument("encoded_file")
    ap.add_argument("--dict", dest="dict_file")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--check-collection")
    ap.add_argument(
        "--engine", choices=["local", "raw", "ladder"], default="local",
        help="local (the dictionary-gather serving image, default) or "
        "ladder (the canonical ladder image); raw is not ported yet",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    decode_stream(
        args.type, args.encoded_file, args.dict_file, args.runs,
        args.check_collection, args.engine, args.device,
    )


if __name__ == "__main__":
    main()
