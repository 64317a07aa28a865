"""Ablation harness for the local decode kernels (timings on the card).

    python -m dint_tpu_torch.tools.kernel_ablate <type> <encoded_file>
        --dict DICT_FILE [--runs 20] [--variants v_ship,v_pallas,...]
        [--device cuda|cpu]

Plans the stream per unit (``decode_local.plan_stream``), builds the
plan-order arrays (hosted vidx, local tables, row counts) and times
decode-kernel variants over them under a chained salt: each run's salt
comes from the previous run's output, on the device, so the runs are
serialized and none waits for the host.  Every variant is checked
bit-exact against the portable flat gather (``decode_local.gather_flat``)
before it is timed.  The variants:

  v_ship         the shipping engine (``LocalDecodeEngine.decode_all``:
                 the rows split into width classes, K1-K3)
  v_gather32     K1 alone over every plan-order row (u8 vidx, full i32
                 tables): the plain gather the one-hot forms stand
                 against, at the same rows and table width
  v_pallas       the one-hot matrix-product gather, 256 rows a thread
                 block (K6, ``decode_pallas.decode_gather_pallas``)
  v_pallas_grid  the same product, one 8-row group a thread block (K7)

Prints one line per variant and a final JSON record.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..backend import device_name, resolve_device
from ..index import stream as stream_mod
from ..kernels import decode_local as dl
from ..kernels import decode_pallas as dp
from . import common
from . import decode as dtool

VARIANTS = ("v_ship", "v_gather32", "v_pallas", "v_pallas_grid")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_runs(fn, runs: int, device) -> float:
    """Timed salted chain; returns seconds per run.  ``fn`` takes the
    salt, a (1,) int64 device tensor, and returns the decoded tensor;
    the next salt is (first output word & 1) + the run's number."""
    def next_salt(outs, k):
        return (outs.reshape(-1)[:1].to(torch.int64) & 1) + k

    salt = next_salt(fn(torch.ones(1, dtype=torch.int64, device=device)), 2)
    int(salt.item())
    salt = torch.ones(1, dtype=torch.int64, device=device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for k in range(runs):
        salt = next_salt(fn(salt), k + 1)
    if device.type == "cuda":
        end.record()
        end.synchronize()
        int(salt.item())
        return start.elapsed_time(end) / 1e3 / runs
    int(salt.item())
    return (time.perf_counter() - t0) / runs


def plan_arrays(plan: dl.LocalPlan, device):
    """The plan-order device arrays, rows zero-padded to a multiple of
    ``decode_pallas.ROW_BLOCK``: vidx (R, N_OUT) int32, the same as
    uint8, table (R, 256) int32 holding u32 bits, n (R,) int32."""
    vidx = dl.plan_to_vidx(plan).astype(np.int32)
    table = np.ascontiguousarray(plan.table, np.uint32).view(np.int32)
    n = plan.out_n.astype(np.int32)
    R = vidx.shape[0]
    padR = -(-R // dp.ROW_BLOCK) * dp.ROW_BLOCK
    if padR != R:
        def z(a):
            pad = np.zeros((padR - R,) + a.shape[1:], a.dtype)
            return np.concatenate([a, pad])
        vidx, table, n = z(vidx), z(table), z(n)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return up(vidx), up(vidx.astype(np.uint8)), up(table), up(n)


def run(plan: dl.LocalPlan, runs: int = 20, variants=VARIANTS,
        device="cuda") -> dict:
    """Check, then time, each variant over ``plan``; returns {"rows",
    "ints", "variants": {name: {"ms_per_run", "ints_per_s"}}}.  A variant
    that is not exact raises."""
    dev = resolve_device(device)
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}")
    total = int(plan.out_n.astype(np.int64).sum())
    vi, v8, tbl, nn = plan_arrays(plan, dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    # plan-order reference via the portable gather (the engine's
    # decode_all is in class-permuted engine order)
    ref = dl.gather_flat(v8, tbl, nn, zero)[: plan.rows]
    out = {"rows": plan.rows, "padded_rows": int(vi.shape[0]), "ints": total,
           "runs": runs, "device": device_name(dev), "variants": {}}

    def record(label, dt):
        out["variants"][label] = {"ms_per_run": dt * 1e3,
                                  "ints_per_s": total / dt}
        print(f"{label:14s} {dt * 1e3:8.3f} ms/run  "
              f"{total / dt / 1e9:7.3f} G ints/s  EXACT")

    for label in variants:
        if label == "v_ship":
            eng = dl.LocalDecodeEngine(plan, device=dev)
            # engine rows are class-permuted: bring them to plan order
            order = torch.from_numpy(eng._eng_of_plan).to(dev)
            got = eng.decode_all(zero)[order]
            _sync(dev)
            if not torch.equal(got, ref):
                raise RuntimeError("v_ship: MISMATCH against gather_flat")
            del got
            record(label, chained_runs(eng.decode_all, runs, dev))
            del eng
            continue
        fn = {
            "v_gather32": lambda s: dl.gather32(v8, tbl, nn, s),
            "v_pallas": lambda s: dp.decode_gather_pallas(vi, tbl, nn, s),
            "v_pallas_grid":
                lambda s: dp.decode_gather_pallas_grid(vi, tbl, nn, s),
        }[label]
        got = fn(zero)[: plan.rows]
        _sync(dev)
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[:3].tolist()
            raise RuntimeError(f"{label}: MISMATCH at {bad}")
        del got
        record(label, chained_runs(fn, runs, dev))
    return out


def plan_of_stream(type_name: str, encoded_file: str,
                   dict_file: str) -> dl.LocalPlan:
    """The per-unit LocalPlan of an encoded DINT stream."""
    multi = common.DINT_KINDS[type_name][0] == "multi"
    arena, meta = stream_mod.load_stream(encoded_file)
    view = dtool.load_dictionary(type_name, dict_file).decode_view()
    lay = dtool.units_from_meta(arena, meta, multi)
    return dl.plan_stream(arena, lay.starts, lay.byte_lens, lay.n, lay.ctx,
                          lay.b_bits, view)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("type", choices=sorted(common.DINT_KINDS))
    ap.add_argument("encoded_file")
    ap.add_argument("--dict", dest="dict_file", required=True)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    plan = plan_of_stream(args.type, args.encoded_file, args.dict_file)
    print(f"rows={plan.rows} ints={int(plan.out_n.astype(np.int64).sum())}")
    out = run(plan, args.runs, args.variants.split(","), args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
