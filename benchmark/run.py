"""Run one cell of the benchmark once on this machine's card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the checkout's root.  Prints the result as the last line of
standard output (one JSON object) and every number the check compared
beside its limit as the last lines of standard error.  Exits non-zero
with no result where there is no card, fewer cards than the cell asks
for, or where ``jax``, ``jaxlib``, ``flax`` or ``dint_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port builds its CUDA and C++ libraries here, inside the checkout
os.environ["DINT_TPU_TORCH_BUILD_DIR"] = os.path.join(ROOT, "dint_tpu_torch",
                                                      "_build")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.manifest import Manifest

    man = Manifest()
    cell = man.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = harness.run_cell(man, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
