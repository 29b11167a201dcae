"""Reads as wgsim (github.com/lh3/wgsim) makes them, at the parameters the
traffic file gives under wgsim's own option names: ``base_error_rate``
(-e), ``mutation_rate`` (-r), ``indel_fraction`` (-R), and for pairs
``outer_distance`` (-d, the fragment's length) and ``outer_distance_std``
(-s). Pairs are FR, read 1 on the fragment's forward strand.

The reads come from ``gen.simulate_reads``, which draws each read's
differences from the genome on its own: substitutions at the sequencing
error rate plus the mutations that are not indels, -e + -r (1 - -R), and
indels at -r -R a base, each 1-3 bases long. wgsim draws the mutations
once into a haplotype that all reads share, and its indels are 1 base
long and grow by one with probability 0.3 (-X); a read sees the same
rates either way.
"""
from __future__ import annotations

import numpy as np

from .. import gen, world


def make_batch(traffic: dict, g: np.ndarray, seed: int,
               index: int) -> world.Batch:
    L = int(traffic["read_len"])
    n = int(traffic["batch_records"])
    paired = traffic["kind"] == "pe"
    mut, frac = traffic["mutation_rate"], traffic["indel_fraction"]
    pair_kw = ({"insert_mean": traffic["outer_distance"],
                "insert_std": traffic["outer_distance_std"]}
               if paired else {})
    recs = gen.simulate_reads(
        g, n // 2 if paired else n, read_len=L,
        error_rate=traffic["base_error_rate"] + mut * (1 - frac),
        indel_rate=mut * frac, seed=[int(seed) & ((1 << 64) - 1), index + 1],
        paired=paired, **pair_kw)
    seqs = np.full((len(recs), L), 4, np.uint8)
    lens = np.zeros(len(recs), np.int32)
    for i, (_, codes) in enumerate(recs):
        seqs[i, :len(codes)] = codes
        lens[i] = len(codes)
    return world.Batch(seqs, lens, [name for name, _ in recs])
