"""``build_s``: seconds of the host index build in set-up (the
collection synthesized and written, the dictionary trained, the lists
encoded), the benchmark's ``build`` span."""


def read(r):
    return r.spans.total["build"] if r.spans.count["build"] else None
