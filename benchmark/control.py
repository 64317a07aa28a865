"""The readings that each limit of ``correct`` is set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c
        [--seconds S]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` at the cell's own load, the program's check (the numbers
a run compares), and the control's: the plain reference put in the
program's place in the next lower precision (the decode's gaps in 16
bits), judged the same way.  One JSON line a seed.
The benchmark's own runs never run the control.
"""

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile

import torch

from benchmark import harness
from benchmark.manifest import Manifest


def readings(man, cell_name: str, seed: int, seconds: float,
             device="cuda") -> dict:
    cell = man.cell(cell_name)
    tr = man.traffic(cell["traffic"])
    kind = man.kind(tr["kind"])
    workdir = tempfile.mkdtemp(prefix="bench-control-",
                               dir=os.environ.get("TMPDIR") or None)
    try:
        ctx = harness.Context(man.config(cell["config"]), tr, seed,
                              torch.device(device), workdir)
        st = kind.setup(ctx)
        kind.window(st, seconds)
        st = kind.release(st)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        program = kind.check(st)
        control = kind.control(st)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"cell": cell_name, "seed": seed,
            "program": {n: v for n, v, _ in program},
            "control": {n: v for n, v, _ in control},
            "limits": {n: lim for n, _, lim in program}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = Manifest()
    for s in args.seeds.split(","):
        with contextlib.redirect_stdout(sys.stderr):
            rec = readings(man, args.workload, int(s), args.seconds)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
