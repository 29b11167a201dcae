"""A one-contig genome made from a published composition: a background of
independent bases at the genome's GC content, then the repeat families,
segmental duplications and microsatellites that the configuration's
``genome`` lists, each entry with the source of its numbers.

A family has a random consensus of ``consensus_len`` bases at
``consensus_gc``; its copies are planted at random places on either strand
until they cover ``share`` of the genome, or ``copies`` of them are placed.
A copy keeps the consensus's last ``length_frac`` of bases (a 5'-truncated
copy, as retrotransposons leave), the fraction drawn uniformly from its
range, and diverges from the consensus by a per-copy substitution rate
drawn from the triangular distribution that ``divergence`` gives as
[least, most common, greatest] (a family's age profile: a peak and two
tails). A segmental duplication copies a stretch of the genome as made so
far, repeats included, to another place with such a divergence;
microsatellites are runs of a 1-6 base motif.
"""
from __future__ import annotations

import numpy as np


def _bases(rng, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def _diverge(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    out = seq.copy()
    m = rng.random(len(out)) < rate
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return out


def _uniform(rng, lo_hi) -> float:
    lo, hi = lo_hi
    return lo + (hi - lo) * rng.random()


def _divergence(rng, lo_mode_hi) -> float:
    return float(rng.triangular(*lo_mode_hi))


def _plant_family(rng, g: np.ndarray, fam: dict):
    n = len(g)
    L = int(fam["consensus_len"])
    cons = _bases(rng, L, fam["consensus_gc"])
    target = int(n * fam["share"]) if "share" in fam else None
    copies = int(fam.get("copies", 0))
    planted = placed = 0
    while (planted < target) if target is not None else (placed < copies):
        m = min(L, max(20, round(L * _uniform(rng, fam["length_frac"]))))
        copy = _diverge(rng, cons[L - m:], _divergence(rng, fam["divergence"]))
        if rng.random() < 0.5:
            copy = (3 - copy[::-1]).astype(np.uint8)
        start = int(rng.integers(0, n - m))
        g[start:start + m] = copy
        planted += m
        placed += 1


def _plant_segdups(rng, g: np.ndarray, sd: dict):
    n = len(g)
    lo, hi = sd["length"]
    target = int(n * sd["share"])
    planted = 0
    while planted < target:
        m = int(rng.integers(lo, hi + 1))
        src, dst = (int(x) for x in rng.integers(0, n - m, 2))
        g[dst:dst + m] = _diverge(rng, g[src:src + m],
                                  _divergence(rng, sd["divergence"]))
        planted += m


def _plant_microsatellites(rng, g: np.ndarray, ms: dict):
    n = len(g)
    target = int(n * ms["share"])
    planted = 0
    lo, hi = ms["repeats"]
    while planted < target:
        motif = _bases(rng, int(rng.integers(1, 7)), 0.5)
        run = np.tile(motif, int(rng.integers(lo, hi + 1)))
        start = int(rng.integers(0, n - len(run)))
        g[start:start + len(run)] = run
        planted += len(run)


def make(config: dict) -> np.ndarray:
    spec = config["genome"]
    n = int(config["genome_len"])
    rng = np.random.default_rng(int(config["genome_seed"]))
    g = _bases(rng, n, spec["gc"])
    for fam in spec.get("families", []):
        _plant_family(rng, g, fam)
    if "segmental_duplications" in spec:
        _plant_segdups(rng, g, spec["segmental_duplications"])
    if "microsatellites" in spec:
        _plant_microsatellites(rng, g, spec["microsatellites"])
    return g
