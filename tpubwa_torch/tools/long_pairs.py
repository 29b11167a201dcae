"""Pairs of long Illumina reads (2x250, 2x300 bp) that the simulator does
not make, used by the long-pair tests and ``chip_smoke.py long_pe``.

``io/fastx.py::simulate_reads`` (like the reference's) clips every insert
to at least twice the read length, so its mates never overlap and never
run into the adapter. A 2x300 library is full of both. Each builder here
is a deterministic function of its arguments and returns interleaved,
FR-oriented ``FastxRecord`` pairs (pair i = records 2i, 2i+1, both under
one name):

* ``overlap_pairs``: inserts between ``read_len`` and ``2 * read_len``,
  so the mates overlap;
* ``readthrough_pairs``: fragments of half a read to a whole read, each
  read its fragment, then the Illumina TruSeq adapter, then random bases;
* ``trimmed_pairs``: simulated pairs whose ends are cut independently to
  36 to ``read_len`` bases, as a trimmer with ``MINLEN:36`` hands them on;
* ``rescue_pairs``: second mates with an error every 7 bases, so only the
  mate rescue places them;
* ``wide_pairs``: inserts from a normal with no clip at twice the read
  length, for a library whose rescue window is wide.
"""
from __future__ import annotations

import numpy as np

from ..io import fastx
from ..utils import dna

# the TruSeq adapters as they appear at the 3' end of read 1 and read 2
ADAPTER_R1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
MIN_LEN = 36        # a trimmer's MINLEN


def _errors(r, rng, error_rate: float):
    """``r`` with substitutions at ``error_rate`` (a copy)."""
    r = r.copy()
    if error_rate > 0:
        hit = (rng.random(len(r)) < error_rate) & (r < 4)
        r[hit] = (r[hit] + rng.integers(1, 4, len(r))[hit]) % 4
    return r


def _pair(name: str, r1, r2) -> list:
    return [fastx.FastxRecord(name, dna.decode(r1)),
            fastx.FastxRecord(name, dna.decode(r2))]


def _fragment_pairs(fwd, n, read_len, rng, draw, error_rate, tag):
    """n FR pairs whose fragment has ``draw()`` bases (at least
    ``read_len``): read 1 the fragment's head, read 2 its tail
    reverse-complemented."""
    out = []
    for i in range(n):
        ins = draw()
        pos = int(rng.integers(0, len(fwd) - ins + 1))
        frag = fwd[pos:pos + ins]
        out += _pair(f"{tag}_{i}_{pos}_{ins}",
                     _errors(frag[:read_len], rng, error_rate),
                     _errors(dna.revcomp(frag)[:read_len], rng, error_rate))
    return out


def overlap_pairs(fwd, n: int, read_len: int, seed: int,
                  error_rate: float = 0.01) -> list:
    """n pairs with inserts drawn evenly from ``read_len`` to ``2 *
    read_len``: the mates overlap by 0 to ``read_len`` bases."""
    rng = np.random.default_rng(seed)
    return _fragment_pairs(
        fwd, n, read_len, rng,
        lambda: int(rng.integers(read_len, 2 * read_len + 1)), error_rate,
        "ovl")


def readthrough_pairs(fwd, n: int, read_len: int, seed: int,
                      error_rate: float = 0.01) -> list:
    """n pairs whose fragment (``read_len // 2`` to ``read_len`` bases) is
    shorter than a read: each read is its fragment's strand, then its
    adapter (``ADAPTER_R1`` on read 1, ``ADAPTER_R2`` on read 2), then
    random bases up to ``read_len``."""
    rng = np.random.default_rng(seed)
    ad = (dna.encode(ADAPTER_R1), dna.encode(ADAPTER_R2))
    out = []
    for i in range(n):
        ins = int(rng.integers(read_len // 2, read_len + 1))
        pos = int(rng.integers(0, len(fwd) - ins + 1))
        frag = fwd[pos:pos + ins]
        reads = []
        for strand, adapter in zip((frag, dna.revcomp(frag)), ad):
            r = np.concatenate([strand, adapter])[:read_len]
            tail = rng.integers(0, 4, read_len - len(r)).astype(np.uint8)
            reads.append(_errors(np.concatenate([r, tail]), rng,
                                 error_rate))
        out += _pair(f"rt_{i}_{pos}_{ins}", *reads)
    return out


def trimmed_pairs(fwd, n: int, read_len: int, seed: int,
                  insert_mean: int, insert_std: int,
                  error_rate: float = 0.01) -> list:
    """n simulated pairs (``simulate_reads``, inserts ``insert_mean`` +-
    ``insert_std``) whose two reads are cut at their 3' ends, each to its
    own length drawn from ``MIN_LEN`` to ``read_len``."""
    recs = fastx.simulate_reads(fwd, n, read_len=read_len,
                                error_rate=error_rate, seed=seed,
                                paired=True, insert_mean=insert_mean,
                                insert_std=insert_std)
    cut = np.random.default_rng(seed + 1).integers(MIN_LEN, read_len + 1,
                                                   len(recs))
    return [fastx.FastxRecord(f"trim_{r.name}", r.seq[:int(c)])
            for r, c in zip(recs, cut)]


def rescue_pairs(fwd, n: int, read_len: int, seed: int, insert: int,
                 step: int = 7) -> list:
    """n pairs with a fragment of ``insert`` bases at a random place whose
    second mate carries an error every ``step`` bases: no seed of the
    default 19 bases fits it, so only the mate rescue places it."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        p = int(rng.integers(0, len(fwd) - insert + 1))
        frag = fwd[p:p + insert]
        r2 = dna.revcomp(frag[-read_len:]).copy()
        for q in range(0, read_len, step):
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        out += _pair(f"resc_{k}_{p}", frag[:read_len], r2)
    return out


def wide_pairs(fwd, n: int, read_len: int, seed: int, insert_mean: int,
               insert_std: int, error_rate: float = 0.01) -> list:
    """n pairs with inserts from a normal of ``insert_mean`` and
    ``insert_std``, kept at ``read_len`` or more (a fragment holds a read)
    and never clipped at ``2 * read_len``.

    The width of the rescue window. bwa's pestat (native/pe.cpp
    ``pestat_core``) sets high = max(p75 + 3 IQR, avg + 4 sd) and low =
    min(p25 - 3 IQR, avg - 4 sd), at least 1; the mate rescue searches
    high - low + read_len bases, and its call's T is the widest window
    rounded up to 256. For a normal, p75 + 3 IQR = avg + 4.72 sd, so
    once 4.72 sd > avg (low at 1) the window is avg + 4.72 sd + read_len
    - 1. T >= 2048 needs a window over 1792 bases: at 2x300 and an
    average of 650, sd > 179 (sd > 211 by avg + 4 sd alone). With
    ``insert_std`` 250 the window is about 2130 bases and T = 2304. A
    rescue task needs a mate that seeding misses, so such a batch carries
    ``rescue_pairs`` too.
    """
    rng = np.random.default_rng(seed)
    return _fragment_pairs(
        fwd, n, read_len, rng,
        lambda: int(np.clip(round(rng.normal(insert_mean, insert_std)),
                            read_len, len(fwd))), error_rate, "wide")
