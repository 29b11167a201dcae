"""Long single-end reads (1-12 kbp and beyond) that the simulator does not
make, used by the long-read tests and ``chip_smoke.py long_se``.

``io/fastx.py::simulate_reads`` (like the reference's) draws short reads
with rare 1-3 bp indels. PacBio and Oxford Nanopore reads, which bwa's
``mem -x pacbio`` and ``-x ont2d`` presets are for, are kilobases long and
carry an error in every 8-10 bases, most of them insertions and
deletions. Everything here is a deterministic function of its arguments
(a seed or a numpy Generator among them):

* ``read_lengths``: a log-normal draw (median ``MEDIAN`` bases) clipped to
  ``[lo, hi]``, as a long-read run's length histogram;
* ``mutate``: a template under a profile's substitutions, insertions and
  deletions;
* ``long_reads``: ``FastxRecord``s of those lengths (or of one
  ``length``) from both strands of a genome, mutated under a ``PROFILES``
  entry, with a share of chimeras: two loci, on independent strands,
  joined in one read, so that the aligner reports a supplementary record
  and ``SA:Z``.

Read names carry the truth: ``lr_<i>_<pos>_<strand>`` (the leftmost
template base on the forward strand), ``lrc_<i>_<pos1>_<pos2>`` for a
chimera.
"""
from __future__ import annotations

import numpy as np

from ..io import fastx
from ..utils import dna

# error rate, then the shares of substitutions, insertions and deletions
PROFILES = {
    "clr": (0.12, 1 / 3, 5 / 12, 1 / 4),    # PacBio CLR: 12%, 2/3 indels
    "ont": (0.10, 0.35, 0.25, 0.40),        # ONT R9: 10%, indel-heavy
    "hifi": (0.005, 0.5, 0.25, 0.25),       # PacBio HiFi (CCS): 0.5%
}
MEDIAN = 6000
SIGMA = 0.6         # log-normal shape: a quartile range of about 4-9 kbp
MIN_LEN, MAX_LEN = 1000, 12288
CHIMERA = 0.05      # share of chimeric reads


def read_lengths(n: int, rng, lo: int = MIN_LEN, hi: int = MAX_LEN,
                 median: int = MEDIAN, sigma: float = SIGMA) -> np.ndarray:
    """n read lengths from a log-normal of the given median, clipped to
    [lo, hi]."""
    x = np.exp(rng.normal(np.log(median), sigma, n))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def mutate(tmpl: np.ndarray, rng, profile: str) -> np.ndarray:
    """The template's bases with the profile's substitutions, insertions
    (a random base before the template base) and deletions, each template
    base independently."""
    e, p_sub, p_ins, _ = PROFILES[profile]
    n = len(tmpl)
    u = rng.random(n)
    sub = (u < e * p_sub) & (tmpl < 4)
    ins = (u >= e * p_sub) & (u < e * (p_sub + p_ins))
    dele = (u >= e * (p_sub + p_ins)) & (u < e)
    base = tmpl.astype(np.uint8)
    base[sub] = (base[sub] + rng.integers(1, 4, n)[sub]) % 4
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(base, counts)
    first = np.cumsum(counts) - counts
    out[first[ins]] = rng.integers(0, 4, int(ins.sum()))
    return out


def _piece(fwd: np.ndarray, n_bases: int, rng, profile: str):
    """n_bases of a mutated template from a random locus and strand:
    (bases, pos, strand), pos the template's first base on the forward
    strand."""
    # a template long enough for the profile's net deletions
    span = min(int(n_bases * 1.15) + 64, len(fwd))
    pos = int(rng.integers(0, len(fwd) - span + 1))
    strand = int(rng.integers(0, 2))
    tmpl = fwd[pos:pos + span]
    if strand:
        tmpl = dna.revcomp(tmpl)
    r = mutate(tmpl, rng, profile)
    while len(r) < n_bases:                 # a draw rich in deletions
        r = np.concatenate([r, mutate(tmpl[-64:], rng, profile)])
    return r[:n_bases], pos, strand


def long_reads(fwd: np.ndarray, n: int, profile: str, seed: int,
               length: int | None = None, lo: int = MIN_LEN,
               hi: int = MAX_LEN, median: int = MEDIAN,
               chimera: float = CHIMERA) -> list:
    """n reads of the genome ``fwd`` (2-bit codes) under ``profile``
    ("clr", "ont" or "hifi"): each ``length`` bases, or lengths from
    ``read_lengths(n, rng, lo, hi, median)``; a share ``chimera`` of them
    joins two loci at a random point between a third and two thirds of
    the read."""
    rng = np.random.default_rng(seed)
    lens = np.full(n, length, np.int64) if length else \
        read_lengths(n, rng, lo, hi, median)
    chim = rng.random(n) < chimera
    out = []
    for i in range(n):
        L = int(lens[i])
        if chim[i]:
            cut = int(rng.integers(L // 3, 2 * L // 3 + 1))
            a, p1, _ = _piece(fwd, cut, rng, profile)
            b, p2, _ = _piece(fwd, L - cut, rng, profile)
            out.append(fastx.FastxRecord(f"lrc_{i}_{p1}_{p2}",
                                         dna.decode(np.concatenate([a, b]))))
            continue
        r, pos, strand = _piece(fwd, L, rng, profile)
        out.append(fastx.FastxRecord(f"lr_{i}_{pos}_{strand}",
                                     dna.decode(r)))
    return out
