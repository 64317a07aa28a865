"""``cache_write_s``: seconds of the statistics file, its ``.side`` sidecar
and the dictionary file written in set-up, the program's span
``build.cache``, self time. None where the span never ran, or where the
program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("build.cache")
    return s["self_s"] if s else None
