"""The single-device entry: the flagship decode step and its example
arguments, the port of the reference package's
``__graft_entry__.entry()``.

    python -m dint_tpu_torch.entry [--device cuda|cpu]

``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` is the
serving-image gather decode (``kernels/decode_local.py``) over a real
plan, the 24 example gap lists of ``parallel/dryrun.example_setup``
encoded with a dictionary trained on them.  On ``cuda`` (the default;
with no card that raises) ``fn`` is one fused K1-K3 class launch of a
``LocalDecodeEngine`` over the plan, exact, as the reference's TPU
branch runs its Pallas class kernels; on ``cpu`` it is the reference's
portable branch, ``decode_gather_rows`` over ``plan_to_vidx``.  The
multi-rank entry, ``dryrun_multichip``, is ``parallel/dryrun.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .backend import device_name, resolve_device


def example_plan(device="cuda"):
    """The example lists' ``LocalPlan`` (per-unit rows, a list a unit);
    their dictionary trained with its merges on ``device``."""
    from .kernels import decode_local
    from .parallel import dryrun

    view, gap_lists, bufs = dryrun.example_setup(device)
    arena = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    starts = np.cumsum([0] + [len(b) for b in bufs])[:-1]
    return decode_local.plan_stream(
        arena, starts, [len(b) for b in bufs], [len(g) for g in gap_lists],
        [0] * len(bufs), [16] * len(bufs), view)


def entry(device="cuda"):
    """(fn, example_args) for the flagship decode step on ``device``."""
    from .kernels import decode_local as dl

    dev = resolve_device(device)
    plan = example_plan(dev)
    salt = torch.zeros(1, dtype=torch.int64, device=dev)
    if dev.type == "cuda":
        eng = dl.LocalDecodeEngine(plan, device=dev)

        def fn(n0, cls16, cls32, salt):
            # engine rows: class-major (zero, u16, i32), each padded; the
            # u16 and i32 classes trimmed, as the engine built and checked
            # them
            return dl.decode_classes(n0, cls16, cls32, salt, exact=True,
                                     check=False)

        return fn, (*eng.launch_args(), salt)

    def fn(vidx, table, n, salt):
        return dl.decode_gather_rows(vidx, table, n, salt)

    return fn, (torch.from_numpy(dl.plan_to_vidx(plan)),
                torch.from_numpy(np.ascontiguousarray(plan.table, np.uint32)
                                 .view(np.int32)),
                torch.from_numpy(np.asarray(plan.out_n, np.int32)), salt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    print(f"entry ok: {tuple(out.shape)} on {device_name(out.device)}",
          flush=True)
    return out


if __name__ == "__main__":
    main()
