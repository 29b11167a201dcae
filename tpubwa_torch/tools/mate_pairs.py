"""Mate-pair libraries (Illumina Nextera Mate Pair) that the simulator does
not make, used by the mate-pair tests and ``chip_smoke.py mate_pair``.

A mate-pair library circularises fragments of a few kbp around a junction
adapter, shears the circles and sequences the piece that holds the
junction from both ends. Its reads face outward (RF): read 1 is the
reverse complement of the fragment's head, read 2 the fragment's tail.
Scaffolders and structural-variant callers use such libraries for their
2-12 kbp inserts. ``mate_pairs`` is a deterministic function of its
arguments and returns interleaved ``FastxRecord`` pairs (pair i = records
2i, 2i+1, both under one name), shuffled, with fragments on either strand
of the genome:

* RF pairs with inserts from a profile (``insert_sizes``): ``gel``, a
  normal of a given mean and sd (a size-selected library); ``unfractionated``,
  uniform over 1.5-10 kbp; ``bimodal``, 30% over 1.0-1.5 kbp and 70% over
  9-10 kbp, which gives pestat its widest windows;
* FR "paired-end contamination" at a given share, inserts 300-600 bp;
* rescue pairs, RF, whose read 2 has an error every 7 bases, so that only
  the mate rescue places it;
* junction reads at a given share: a read that runs through the junction
  adapter ``JUNCTION`` into the fragment's other end, as untrimmed
  mate-pair reads do, which makes supplementary records and ``SA:Z``.

``pestat`` mirrors bwa's insert-size statistics (native/pe.cpp
``pestat_core``) on a histogram such as ``Aligner._pe_hist`` returns, so a
run can report each orientation's ``low``, ``high`` and ``failed`` and the
rescue windows they give (``window``, ``rescue_T``).
"""
from __future__ import annotations

import numpy as np

from ..io import fastx
from ..utils import dna
from .long_pairs import _errors, _pair

JUNCTION = "CTGTCTCTTATACACATCT"   # the Nextera junction adapter
PROFILES = ("gel", "unfractionated", "bimodal")
FR_INSERTS = (300, 600)         # paired-end contamination
JUNCTION_MIN = 30               # bases of each side of a junction read
# bwa's orientations by pestat's index [bwa: mem_infer_dir]
ORIENTATIONS = ("FF", "FR", "RF", "RR")
# native/pe.cpp's pestat constants
_MIN_DIR_CNT, _MIN_DIR_RATIO = 10, 0.05
_OUTLIER, _MAPPING, _MAX_SD = 2.0, 3.0, 4.0


def insert_sizes(n: int, profile: str, rng, mean: int = 3000,
                 sd: int = 300) -> np.ndarray:
    """n mate-pair inserts drawn from ``profile`` (see the module doc);
    ``mean`` and ``sd`` are the gel's. A gel insert is at least 1,000."""
    if profile == "gel":
        x = np.maximum(np.rint(rng.normal(mean, sd, n)), 1000)
    elif profile == "unfractionated":
        x = rng.integers(1500, 10001, n)
    elif profile == "bimodal":        # 30% short exactly, in random order
        short = rng.permutation(n) < round(0.3 * n)
        x = np.where(short, rng.integers(1000, 1501, n),
                     rng.integers(9000, 10001, n))
    else:
        raise ValueError(f"unknown insert profile {profile!r}; "
                         f"one of {PROFILES}")
    return x.astype(np.int64)


def _fragment(fwd, ins: int, rng):
    """A fragment of ``ins`` bases at a random place on a random strand:
    (its bases, its place, "f" or "r")."""
    pos = int(rng.integers(0, len(fwd) - ins + 1))
    frag = fwd[pos:pos + ins]
    if rng.random() < 0.5:
        return frag, pos, "f"
    return dna.revcomp(frag), pos, "r"


def _junction_read(frag, read_len: int, rng, first: bool):
    """A read through the junction: read 1 reads back from the head into
    the adapter and on into the tail, read 2 on from the tail through the
    adapter into the head; at least JUNCTION_MIN bases each side."""
    jn = dna.encode(JUNCTION)
    y = int(rng.integers(JUNCTION_MIN,
                         read_len - len(jn) - JUNCTION_MIN + 1))
    k = read_len - len(jn) - y
    if first:                       # head's first y bases, then the tail
        return dna.revcomp(np.concatenate([frag[-k:], jn, frag[:y]]))
    return np.concatenate([frag[-y:], jn, frag[:k]])


def mate_pairs(fwd, n: int, read_len: int, seed: int,
               profile: str = "unfractionated", mean: int = 3000,
               sd: int = 300, fr_share: float = 0.15, rescue: int = 0,
               junction_share: float = 0.0,
               error_rate: float = 0.01) -> list:
    """n pairs of ``read_len`` bases on genome ``fwd`` (uint8 codes):
    round(fr_share * n) FR pairs with inserts over FR_INSERTS, ``rescue``
    RF rescue pairs, the rest RF pairs with inserts from ``profile``
    (``mean``, ``sd`` for ``gel``); each read a junction read with
    probability ``junction_share`` (rescue pairs excepted); substitutions
    at ``error_rate``. Names: ``mp_`` (RF), ``fr_``, ``mpr_`` (rescue),
    then the pair's index, place, insert and strand, and ``_j1`` / ``_j2``
    when read 1 / read 2 runs through the junction."""
    rng = np.random.default_rng(seed)
    n_fr = int(round(fr_share * n))
    n_mp = n - n_fr - rescue
    if n_mp < 0:
        raise ValueError(f"{n} pairs hold no {n_fr} FR and {rescue} rescue "
                         "pairs")
    kinds = ["mp"] * n_mp + ["fr"] * n_fr + ["mpr"] * rescue
    mp_ins = iter(insert_sizes(n_mp + rescue, profile, rng, mean, sd))
    out = []
    for i in rng.permutation(len(kinds)):
        kind = kinds[i]
        ins = int(rng.integers(FR_INSERTS[0], FR_INSERTS[1] + 1)) \
            if kind == "fr" else int(next(mp_ins))
        ins = max(ins, read_len)
        frag, pos, strand = _fragment(fwd, ins, rng)
        if kind == "fr":
            r1, r2 = frag[:read_len], dna.revcomp(frag)[:read_len]
        else:
            r1, r2 = dna.revcomp(frag[:read_len]), frag[-read_len:]
        tag = ""
        if kind == "mp":
            if rng.random() < junction_share:
                r1 = _junction_read(frag, read_len, rng, True)
                tag += "_j1"
            if rng.random() < junction_share:
                r2 = _junction_read(frag, read_len, rng, False)
                tag += "_j2"
        r1 = _errors(r1, rng, error_rate)
        if kind == "mpr":
            r2 = r2.copy()
            for q in range(0, read_len, 7):
                r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        else:
            r2 = _errors(r2, rng, error_rate)
        out += _pair(f"{kind}_{i}_{pos}_{ins}_{strand}{tag}", r1, r2)
    return out


def batch(fwd, n: int, read_len: int, seed: int, **kw):
    """``mate_pairs`` as one ReadBatch of width ``read_len``."""
    return fastx.batch_reads(mate_pairs(fwd, n, read_len, seed, **kw),
                             max_len=read_len)


def pestat(hist, max_ins: int) -> list:
    """bwa's insert-size statistics [native/pe.cpp pestat_core] from a
    (4, max_ins + 1) histogram of (orientation, insert) samples: one dict
    a orientation (``ORIENTATIONS``' order) with ``n``, ``failed``,
    ``low``, ``high``, ``avg`` and ``std``, in the native code's integer
    and double arithmetic."""
    hist = np.asarray(hist, np.int64).reshape(4, max_ins + 1)
    out = []
    for d in range(4):
        q = np.repeat(np.arange(max_ins + 1), hist[d])
        n = len(q)
        r = dict(orientation=ORIENTATIONS[d], n=n, failed=1, low=0, high=0,
                 avg=0.0, std=0.0)
        out.append(r)
        if n < _MIN_DIR_CNT:
            continue
        r["failed"] = 0
        p25 = int(q[int(.25 * n + .499)])
        p75 = int(q[int(.75 * n + .499)])
        low = max(int(p25 - _OUTLIER * (p75 - p25) + .499), 1)
        high = int(p75 + _OUTLIER * (p75 - p25) + .499)
        avg, x = 0.0, 0
        for v in q.tolist():
            if low <= v <= high:
                avg += float(v)
                x += 1
        avg /= x
        var = 0.0
        for v in q.tolist():
            if low <= v <= high:
                var += (v - avg) * (v - avg)
        std = float(np.sqrt(var / x))
        low = int(p25 - _MAPPING * (p75 - p25) + .499)
        high = int(p75 + _MAPPING * (p75 - p25) + .499)
        if low > avg - _MAX_SD * std:
            low = int(avg - _MAX_SD * std + .499)
        if high < avg + _MAX_SD * std:
            high = int(avg + _MAX_SD * std + .499)
        r.update(low=max(low, 1), high=high, avg=avg, std=std)
    mx = max(r["n"] for r in out)
    for r in out:
        if not r["failed"] and r["n"] < mx * _MIN_DIR_RATIO:
            r["failed"] = 1
    return out


def window(r: dict, l_ms: int) -> int:
    """The rescue window of an orientation's statistics ``r`` for a mate
    of ``l_ms`` bases, before a contig's ends cut it [bwa: mem_matesw]."""
    return r["high"] - r["low"] + l_ms


def rescue_T(pes: list, l_ms: int) -> int:
    """The widest rescue call's T for mates of ``l_ms`` bases: the widest
    live orientation's window rounded up to 256 as pair/rescue.py rounds
    it (0 when every orientation failed)."""
    w = max((window(r, l_ms) for r in pes if not r["failed"]), default=0)
    return -(-w // 256) * 256 if w else 0
