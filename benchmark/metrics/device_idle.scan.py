"""``device_idle.scan``: the share of the measured window of chained decodes
in which no operation ran on the card: 1 - (device busy time a chained run in
the traced slice, from torch.profiler, times the window's chained runs) / the
window's time.  The traced slice's own idle share (``busy_s`` over
``window_s`` of the result) also holds the profiler's host cost, paid
per host operation: for the scan, 15-29% against about 4% untraced."""


def read(r):
    prof, f = r.profile, r.facts
    if not prof or not prof["busy_s"] or not r.work or not f.get("window_s"):
        return None
    busy = prof["busy_s"] / r.work * f["window_work"]
    return 100.0 * (1.0 - busy / f["window_s"])
