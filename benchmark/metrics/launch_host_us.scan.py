"""``launch_host_us.scan``: the host's own microseconds a fused decode
launch, over the calls of set-up's warm-up and of the window (spans under
the profiler land in its trace, not in the table): the self time of the
program's span ``decode.launch`` (checks, the output's allocation, the
pointers packed, the library fetched) a call.  The span ``decode.enqueue``
inside it, the library call, is not counted: once the host is ahead, a
launch waits there for room in the card's launch queue, which is the
card's time.  None where the span never ran, or where the program keeps
no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("decode.launch")
    return 1e6 * s["self_s"] / s["count"] if s else None
