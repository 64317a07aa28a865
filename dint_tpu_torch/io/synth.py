"""Synthetic test collections.

The reference ships a 113,306-list / 3,327,520-posting sample collection
whose `.docs`/`.freqs` blobs are absent from our snapshot, so local baselines are
measured on synthesized compatible collections.  The generator mirrors
the shape of real inverted indexes: Zipf-ish list lengths, clustered
docIDs (runs of consecutive documents, which produce zero d-gaps — the
pattern DINT's run codewords exploit), and small skewed frequencies.

Randomness mirrors the reference's test fixture style
(test/test_generic_sequence.hpp:7-26) but is numpy-vectorized.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def random_posting_list(
    rng: np.random.Generator, universe: int, n: int, cluster: float = 0.3
) -> np.ndarray:
    """Strictly-increasing docid list of length n over [0, universe).

    ``cluster`` is the probability that a posting continues a run of
    consecutive documents (gap of 1); the remaining mass is spread
    geometrically so the expected total span stays within the universe.
    """
    assert 0 < n <= universe
    # Gap budget: sum(gaps) <= universe with every gap >= 1.
    # With prob `cluster` the gap is exactly 1 (consecutive docs ->
    # zero d-gap, the pattern DINT run codewords exploit); otherwise
    # 1 + Geom.  If the draw overspends the universe, the non-run
    # extras are scaled down — strict monotonicity is preserved
    # because the base gap of 1 is untouched.
    is_run = rng.random(n) < cluster
    mean_extra = max((universe / max(n, 1) - 1.0) / max(1e-9, (1.0 - cluster)), 0.001)
    p = min(1.0, 1.0 / (1.0 + mean_extra))
    extra = (rng.geometric(p, size=n) - 1).astype(np.int64)
    extra[is_run] = 0
    total = n + int(extra.sum())
    if total > universe:
        budget = universe - n
        ext_total = max(int(extra.sum()), 1)
        extra = (extra * (budget * 0.98 / ext_total)).astype(np.int64)
    gaps = 1 + extra
    docs = np.cumsum(gaps) - 1
    assert int(docs[-1]) < universe
    return docs.astype(np.uint32)


def random_freqs(rng: np.random.Generator, n: int) -> np.ndarray:
    """Small skewed positive frequencies (mostly 1..4)."""
    f = rng.zipf(2.0, size=n)
    return np.minimum(f, 1 << 20).astype(np.uint32)


def zipf_lengths(
    rng: np.random.Generator,
    num_lists: int,
    target_sum: int,
    cap: int,
) -> np.ndarray:
    """Zipf-tailed list lengths with an EXACT total, each in [1, cap].

    Rank-frequency power law (Zipf's law proper): len(rank) =
    cap * rank^-alpha, with alpha binary-searched so the total hits
    target_sum.  (Sampling i.i.d. Zipf values and rescaling degenerates
    when cap << the tail: the cap destroys the mass and ~everything
    collapses to length 1.)
    """
    ranks = np.arange(1, num_lists + 1, dtype=np.float64)

    def lens_of(alpha: float) -> np.ndarray:
        return np.maximum(
            1, np.round(cap * ranks ** -alpha)
        ).astype(np.int64)

    lo, hi = 0.0, 12.0  # sum decreases as alpha grows
    for _ in range(80):
        mid = (lo + hi) / 2
        if int(lens_of(mid).sum()) > target_sum:
            lo = mid
        else:
            hi = mid
    lens = lens_of(lo)
    rng.shuffle(lens)
    # exact correction: walk off the residual one list at a time
    diff = int(lens.sum()) - target_sum
    i = 0
    order = np.argsort(-lens)
    while diff != 0 and i < num_lists:
        j = order[i % num_lists]
        if diff > 0 and lens[j] > 1:
            lens[j] -= 1
            diff -= 1
        elif diff < 0 and lens[j] < cap:
            lens[j] += 1
            diff += 1
        i += 1
    return lens


def make_collection(
    num_lists: int,
    num_docs: int,
    seed: int = 1,
    avg_len: float = 30.0,
    cluster: float = 0.3,
    target_postings: int = 0,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """A (doc_lists, freq_lists) pair shaped like the bundled sample.

    List lengths follow a truncated Zipf so a few terms are dense (long
    runs, highly compressible) and the long tail is short, as in real
    collections.  With target_postings > 0 the lengths are rescaled so
    the total posting count is exact even when num_docs caps the tail.
    """
    rng = np.random.default_rng(seed)
    if target_postings:
        lens = zipf_lengths(rng, num_lists, int(target_postings), num_docs)
    else:
        raw = rng.zipf(1.35, size=num_lists).astype(np.float64)
        lens = np.maximum(1, (raw / raw.mean() * avg_len)).astype(np.int64)
        lens = np.minimum(lens, num_docs)
    doc_lists: List[np.ndarray] = []
    freq_lists: List[np.ndarray] = []
    for n in lens:
        n = int(n)
        doc_lists.append(random_posting_list(rng, num_docs, n, cluster))
        freq_lists.append(random_freqs(rng, n))
    return doc_lists, freq_lists


def bursty_posting_list(
    rng: np.random.Generator,
    universe: int,
    n: int,
    avg_burst: float = 32.0,
    within_cluster: float = 0.75,
) -> np.ndarray:
    """Strictly-increasing docid list with CRAWL-LIKE locality.

    Real collections ordered by URL (Gov2/ClueWeb, the reference's
    benchmark corpora — README.md:105-116) concentrate a term's
    postings in bursts: consecutive documents from the same site match
    together, separated by long dead stretches.  The uniform-geometric
    model (random_posting_list) spreads postings evenly, which flattens
    per-block maxima and makes Block-Max pruning look weak
    (docs/STATUS.md "uniform random weights prune weakly").

    Model: the list is a sequence of bursts.  Burst lengths are
    geometric with mean ``avg_burst``; within a burst gaps are 1 with
    probability ``within_cluster`` (zero d-gaps — DINT run codewords)
    else 2..4; bursts are separated by Pareto-tailed jumps (power-law
    gap distribution), scaled so the list spans most of the universe.
    """
    assert 0 < n <= universe
    # burst id per posting: geometric run lengths with mean avg_burst
    p_new = min(1.0, 1.0 / max(avg_burst, 1.0))
    new_burst = rng.random(n) < p_new
    new_burst[0] = True
    burst_id = np.cumsum(new_burst) - 1
    n_bursts = int(burst_id[-1]) + 1
    # within-burst gaps: mostly 1 (runs), sometimes 2..4
    gaps = np.where(
        rng.random(n) < within_cluster,
        1,
        rng.integers(2, 5, size=n),
    ).astype(np.int64)
    # between-burst jumps: Pareto (power-law) — heavy tail like the
    # distance between successive sites matching a term
    jumps = (1.0 + rng.pareto(1.3, size=n_bursts)).astype(np.float64)
    # scale jumps so the expected total span fits ~90% of the universe
    within_total = int(gaps.sum())
    budget = max(int(universe * 0.9) - within_total, n_bursts)
    jumps = np.maximum(
        1, (jumps / jumps.sum() * budget)
    ).astype(np.int64)
    gaps[new_burst] = np.maximum(gaps[new_burst], jumps)
    docs = np.cumsum(gaps) - 1
    # over-budget tails (pareto draw variance) fold back by rescale
    if int(docs[-1]) >= universe:
        scale = max((universe - 1 - n) / max(float(docs[-1] - n), 1.0), 0.0)
        extra = np.maximum(gaps - 1, 0)
        gaps = 1 + (extra * scale).astype(np.int64)
        docs = np.cumsum(gaps) - 1
    assert int(docs[-1]) < universe
    assert docs.shape[0] == n
    return docs.astype(np.uint32)


def skewed_freqs(
    rng: np.random.Generator, docs: np.ndarray, verbosity: np.ndarray,
    a: float = 1.8,
) -> np.ndarray:
    """Frequencies correlated with per-document verbosity.

    Uniform-random freqs give every 256-posting block a similar maximum
    BM25 weight, so block-max pruning barely skips.  Real term
    frequencies scale with document length/verbosity, which varies by
    site — and with docids in crawl order, verbosity is LOCALLY
    correlated, giving blocks genuinely different score ceilings.
    ``verbosity`` is a per-document multiplier (see
    make_skewed_collection).
    """
    # ``a``: zipf exponent of the base term-frequency draw — steeper
    # means a larger tf=1 share (real crawls sit near 70-80% ones;
    # calibrated against the reference's published freqs bpi by
    # scripts/calibrate_skew.py)
    base = rng.zipf(a, size=docs.shape[0])
    f = np.maximum(
        1, (base * verbosity[docs.astype(np.int64)]).astype(np.int64)
    )
    return np.minimum(f, 1 << 20).astype(np.uint32)


def make_skewed_collection(
    num_lists: int,
    num_docs: int,
    seed: int = 1,
    avg_len: float = 30.0,
    target_postings: int = 0,
    avg_burst: float = 32.0,
    freq_zipf: float = 1.8,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """A crawl-shaped collection: power-law gaps via bursty docid
    locality + verbosity-correlated frequencies (VERDICT r3 item 6).

    Same length model as make_collection; differs in WHERE postings
    land (bursts separated by Pareto jumps instead of even spread) and
    in freq structure (per-doc verbosity field with site-level
    correlation).  This makes selector/partition mixes, per-block
    maxima, and therefore BMW/WAND pruning behave like the reference's
    published Gov2/ClueWeb numbers rather than the uniform synthetic's
    flattering flat blocks.
    """
    rng = np.random.default_rng(seed)
    if target_postings:
        lens = zipf_lengths(rng, num_lists, int(target_postings), num_docs)
    else:
        raw = rng.zipf(1.35, size=num_lists).astype(np.float64)
        lens = np.maximum(1, (raw / raw.mean() * avg_len)).astype(np.int64)
        lens = np.minimum(lens, num_docs)
    # per-document verbosity: site blocks of ~1000 docs share a
    # lognormal multiplier (crawl order groups same-site docs), plus
    # per-doc jitter
    n_sites = max(num_docs // 1000, 1)
    site_verb = rng.lognormal(0.0, 0.8, size=n_sites)
    site_of = np.minimum(
        np.arange(num_docs) // 1000, n_sites - 1
    )
    verbosity = site_verb[site_of] * rng.lognormal(0.0, 0.4, size=num_docs)
    doc_lists: List[np.ndarray] = []
    freq_lists: List[np.ndarray] = []
    for n in lens:
        n = int(n)
        d = bursty_posting_list(rng, num_docs, n, avg_burst=avg_burst)
        doc_lists.append(d)
        freq_lists.append(skewed_freqs(rng, d, verbosity, a=freq_zipf))
    return doc_lists, freq_lists


def doc_sizes_from_lists(
    doc_lists: List[np.ndarray], freq_lists: List[np.ndarray], num_docs: int
) -> np.ndarray:
    """Per-document lengths: sum of freqs of postings naming the doc."""
    sizes = np.zeros(num_docs, dtype=np.int64)
    for d, f in zip(doc_lists, freq_lists):
        np.add.at(sizes, d.astype(np.int64), f.astype(np.int64))
    return np.maximum(sizes, 1).astype(np.uint32)
