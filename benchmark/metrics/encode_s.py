"""``encode_s``: seconds of the lists gap-transformed, encoded and written
in set-up, the program's span ``build.encode``, self time. None where
the span never ran, or where the program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("build.encode")
    return s["self_s"] if s else None
