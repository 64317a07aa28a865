"""``load_s``: seconds of the host plan and device load in set-up
(``StreamDecoder``'s image planned and uploaded), the benchmark's
``load`` span."""


def read(r):
    return r.spans.total["load"] if r.spans.count["load"] else None
