"""``upload_s``: seconds of the class arrays padded and copied to the card
in set-up (the copies are not waited for), the program's span
``load.upload``, self time. None where the span never ran, or where the
program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("load.upload")
    return s["self_s"] if s else None
