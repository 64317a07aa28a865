"""Traffic kind ``scan``: the whole docid stream decoded again and again.

Set-up writes the seed's ``.docs``, encodes it as the configuration's
``stream_type`` (``tools/encode.encode_collection``: the dictionary
trained, the lists encoded), plans the serving image and uploads it
(``tools/decode.StreamDecoder``, the gather image, no image cache on
disk: every run has a new collection), and warms the chain up.

The window runs the chain of ``ImageDecodeEngine.decode_chain`` call
after call: each run one fused K1-K3 launch (``_run``, raw: the zero and
u16 classes add the salt) and a checksum, on the card.  The benchmark
drives the runs itself so that the calls chain: the first salt comes
from the seed and each call starts at the final salt of the call before,
where ``decode_chain`` starts every call at 1.  The checksum reads the
same rows as ``decode_chain``'s, the first ``SUM_ROWS`` rows of each
class, but a run enqueues five ops besides the launch where
``decode_chain`` enqueues fourteen (one gather of the rows, one int32
sum wrapping modulo 2^32, three for the next salt), so that the host's
enqueue keeps ahead of the card.  The next salt is 4 times that sum,
plus the salt, plus 1, modulo 2^32 (``decode_chain`` adds the sum once):
the sum holds the salt once for each salted lane it covers, so the step
is ``salt -> a * salt + b`` with ``a`` 1 modulo 4 and ``b`` odd, whose
orbit runs through all 2^32 salts before it repeats, where
``decode_chain``'s ``a``, one plus the salted lanes, can be even and its
salts fall into a short cycle whatever the start.  Every run decodes
every posting of the collection.

The check holds what the window produced to the reference: the whole
output of one run of the window, drawn from the seed (reservoir-sampled
over the calls, so the program cannot tell which), its salt taken off,
put back into lists by the program's layout and held int for int to the
reference's gaps; and every call's final salt held to the chain
replayed on the host from that output, starting at the salt the call
was given.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import collection, reference, roofline

U32 = 0xFFFFFFFF
SUM_ROWS = 128  # rows of each class the chain's checksum sums


def setup(ctx):
    from dint_tpu_torch.dictionary import builder
    from dint_tpu_torch.index import stream as stream_mod
    from dint_tpu_torch.tools import common, decode, encode

    cfg, tr = ctx.config, ctx.traffic
    stype = cfg["stream_type"]
    kind, policy = common.DINT_KINDS[stype]
    base = os.path.join(ctx.workdir, "coll")
    stream_file = os.path.join(ctx.workdir, f"coll.{stype}.bin")
    with ctx.spans.span("build"):
        coll = collection.make(cfg["collection"], ctx.seed)
        collection.write(base, coll)
        encode.encode_collection(stype, base + ".docs", stream_file,
                                 cache_dir=ctx.workdir, device=ctx.device)
    dict_file = os.path.join(ctx.workdir, builder.dict_cache_name(
        base + ".docs", kind, policy or "pack"))
    with ctx.spans.span("load"):
        arena, meta = stream_mod.load_stream(stream_file)
        view = decode.load_dictionary(stype, dict_file).decode_view()
        dec = decode.StreamDecoder(arena, meta, view, kind == "multi",
                                   "local", None, ctx.device)
    eng = dec.engine
    rng = collection.rng_of(ctx.seed, 1)
    first = int(rng.integers(0, 1 << 32))
    st = {"ctx": ctx, "coll": coll, "dec": dec, "runs": int(tr["runs_per_call"]),
          "ints": coll.postings, "rng": rng, "starts": [first], "finals": [],
          "calls": 0, "kept": None,
          "sum_rows": torch.cat([
              torch.arange(c.base, c.base + min(c.rows, SUM_ROWS))
              for c in eng._classes if c.rows]).to(ctx.device),
          "salt": eng._salt(first)}
    for _ in range(int(tr["warmup_calls"])):
        _call(st, sample=False)
    _sync(ctx.device)
    ctx.facts["postings"] = coll.postings
    ctx.facts["decode_bytes"] = roofline.decode_bytes(stream_file,
                                                      dict_file, coll.postings)
    return st


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _call(st, sample: bool = True) -> None:
    """One call of ``runs`` chained runs from the chain's current salt.
    A sampled call takes part in the draw of the run whose whole output
    the check reads: the i-th sampled call replaces the kept run with
    probability 1/i, at a run drawn from the seed."""
    eng, runs, rows = st["dec"].engine, st["runs"], st["sum_rows"]
    keep_at = -1
    if sample:
        st["calls"] += 1
        take = st["rng"].random() * st["calls"] < 1.0
        at = int(st["rng"].integers(runs))
        keep_at = at if take else -1
    salt = st["salt"]
    for r in range(runs):
        buf = eng._run(salt)
        if r == keep_at:
            st["kept"] = (buf, salt)
        acc = buf.index_select(0, rows).sum(dtype=torch.int32)
        del buf  # the next run's launch may reuse its block
        salt = (torch.add(salt, acc, alpha=4) + 1) & U32
    st["salt"] = salt
    st["finals"].append(salt)


def window(st, seconds: float) -> dict:
    ctx = st["ctx"]
    before = len(st["finals"])
    _sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        with ctx.spans.span("decode_chain"):
            _call(st)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(ctx.device)
    wall = time.perf_counter() - t0
    st["window_runs"] = (len(st["finals"]) - before) * st["runs"]
    ctx.facts["window_s"], ctx.facts["window_work"] = wall, st["window_runs"]
    return {"decode_ints_per_s": st["window_runs"] * st["ints"] / wall,
            "attempted": st["window_runs"]}


def traced_work(st):
    """A slice of the same calls for the profiler, continuing the chain;
    the work unit of the per-layer metrics is a chained run."""
    ctx = st["ctx"]
    calls = int(ctx.traffic["trace_calls"])

    def work():
        for _ in range(calls):
            with ctx.spans.span("decode_chain"):
                _call(st, sample=False)

    return work, calls * st["runs"]


def release(st):
    """Keep on the host what the check needs (every call's final salt,
    the kept run's output with its salt taken off, in lists by the
    program's layout) and free the program's state."""
    dec = st["dec"]
    eng = dec.engine
    finals = torch.stack([s.reshape(()) for s in st["finals"]]).cpu().numpy()
    buf, salt = st["kept"]
    salt = int(salt)
    raw = buf.cpu().numpy().view(np.uint32)
    classes = [(c.mode, c.base, c.rows,
                c.n.cpu().numpy() if c.n is not None else None)
               for c in eng._classes]
    exact = _unsalt(raw, classes, salt)
    units = eng.gather_units(torch.from_numpy(exact.view(np.int32)),
                             len(dec.layout.starts), dec.layout.n)
    st["got"] = np.concatenate(units) if units else np.zeros(0, np.uint32)
    st["finals"] = finals
    st["replay"] = _replay(exact, classes, np.asarray(st["starts"]
                                                      + list(finals[:-1])),
                           st["runs"])
    del st["dec"], st["kept"], st["salt"], dec, eng, units, raw, buf
    return st


def _valid(n, n_out):
    return np.arange(n_out)[None, :] < n[:, None]


def _unsalt(raw, classes, salt):
    """The raw output, in place, with the salt taken off the valid lanes
    of the classes whose launch adds it (zero and u16, as
    ``decode_classes`` documents)."""
    for mode, base, rows, n in classes:
        if not rows or mode == 32:
            continue
        blk = raw[base:base + rows]
        m = _valid(n, blk.shape[1])
        blk[m] = (blk[m].astype(np.int64) - salt) & U32
    return raw


def _replay(exact, classes, starts, runs):
    """Each call's final salt, replayed on the host from the exact output
    and the salt the call started at: a run's next salt is 4 times the
    u32 sum of the first ``SUM_ROWS`` rows of each class of its raw
    output (the exact sum plus the salt once for each valid lane of a
    salted class in those rows), plus the salt, plus 1."""
    e_sum, v_salted = 0, 0
    for mode, base, rows, n in classes:
        if not rows:
            continue
        take = min(rows, SUM_ROWS)
        e_sum += int(exact[base:base + take].astype(np.int64).sum())
        if mode != 32:
            v_salted += int(np.minimum(n[:take], exact.shape[1]).sum())
    out = np.empty(len(starts), np.int64)
    for i, s in enumerate(starts):
        s = int(s)
        for _ in range(runs):
            s = (4 * (e_sum + s * v_salted) + s + 1) & U32
        out[i] = s
    return out


def check(st) -> list:
    """[(name, value, limit)]: ints of the kept run that differ from the
    reference's gaps (missing or extra ints count each), and calls whose
    final salt differs from the replay."""
    coll = st["coll"]
    want = reference.docid_gaps(coll.docs, coll.starts)
    got = st["got"]
    n = min(got.shape[0], want.shape[0])
    wrong = int(np.count_nonzero(got[:n] != want[:n])) + abs(
        got.shape[0] - want.shape[0])
    salts_wrong = int(np.count_nonzero(st["finals"] != st["replay"]))
    st["failed"] = salts_wrong * st["runs"] if not wrong else st.get(
        "window_runs", 0)
    lim = st["ctx"].config["limits"]
    return [("ints_wrong", wrong, lim["ints_wrong"]),
            ("chain_salts_wrong", salts_wrong, lim["chain_salts_wrong"])]


def control(st) -> list:
    """The control in the program's place: the reference's gaps carried
    in 16 bits, judged like the program's output."""
    coll = st["coll"]
    want = reference.docid_gaps(coll.docs, coll.starts)
    got = reference.narrowed_gaps(want, 16)
    return [("ints_wrong", int(np.count_nonzero(got != want)),
             st["ctx"].config["limits"]["ints_wrong"])]
