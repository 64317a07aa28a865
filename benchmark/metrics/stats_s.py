"""``stats_s``: seconds of the block statistics collected in set-up (the
native collector and any device merges), the program's span
``build.stats``, self time. None where the span never ran, or where the
program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("build.stats")
    return s["self_s"] if s else None
