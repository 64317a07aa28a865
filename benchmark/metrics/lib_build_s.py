"""``lib_build_s``: seconds of the native and CUDA libraries' freshness
checks, and of their compiles where one was stale, the program's span
``lib.build``, total time. None where the span never ran, or where the
program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("lib.build")
    return s["total_s"] if s else None
