"""``plan_s``: seconds of the serving image planned in set-up (the native
planner's shards and their concatenation), the program's span
``load.plan``, self time. None where the span never ran, or where the
program keeps no span table."""


def read(r):
    try:
        from dint_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.snapshot().get("load.plan")
    return s["self_s"] if s else None
