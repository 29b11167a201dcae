"""Reads with known differences from the genome, deterministic in their seed.

A frozen copy of the aligner's own read simulator (``io/fastx.py::
simulate_reads``) as it stood when the benchmark was defined, so that a
change to the program cannot change what the benchmark feeds it.
``tests/test_bench_gen.py`` holds the copy equal to the program's function
at a small size. ``reads/wgsim.py`` sets its rates from a traffic file.
"""
from __future__ import annotations

import numpy as np

_COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.uint8)[::-1]]


def simulate_reads(ref: np.ndarray, n: int, read_len: int = 100,
                   error_rate: float = 0.0, indel_rate: float = 0.0,
                   seed: int = 0, paired: bool = False,
                   insert_mean: int = 350, insert_std: int = 35):
    """Reads (pairs interleaved, FR) as [(name, codes)]; names carry the
    truth locus: ``sim_<i>_<pos>_<strand>``, pairs ``sim_<i>_<pos>_<ins>``."""
    rng = np.random.default_rng(seed)
    L = len(ref)
    slack = 8 + int(np.ceil(4 * read_len * indel_rate)) if indel_rate > 0 \
        else 0
    out = []
    for i in range(n):
        if paired:
            ins = int(np.clip(rng.normal(insert_mean, insert_std),
                              2 * read_len, L))
            pos = int(rng.integers(0, L - ins - slack + 1))
            frag = ref[pos: pos + ins + slack]
            r1 = _mutate(frag[: read_len + slack], rng, read_len,
                         error_rate, indel_rate)
            r2 = _mutate(revcomp(frag[:ins])[: read_len + slack], rng,
                         read_len, error_rate, indel_rate)
            out.append((f"sim_{i}_{pos}_{ins}", r1))
            out.append((f"sim_{i}_{pos}_{ins}", r2))
            continue
        strand = int(rng.integers(0, 2))
        pos = int(rng.integers(0, L - read_len - slack + 1))
        r = ref[pos: pos + read_len + slack]
        if strand:
            r = revcomp(r)
        r = _mutate(r, rng, read_len, error_rate, indel_rate)
        tpos = pos + slack if strand else pos
        out.append((f"sim_{i}_{tpos}_{strand}", r))
    return out


def _mutate(window: np.ndarray, rng: np.random.Generator, read_len: int,
            error_rate: float, indel_rate: float) -> np.ndarray:
    r = window[:read_len].copy()
    if error_rate > 0:
        errs = (rng.random(read_len) < error_rate) & (r < 4)
        shift = rng.integers(1, 4, size=read_len).astype(np.uint8)
        r[errs] = (r[errs] + shift[errs]) % 4
    n_ind = int(rng.binomial(read_len, indel_rate)) if indel_rate > 0 else 0
    if n_ind == 0:
        return r
    out: list[int] = []
    i = 0
    events = set(int(x) for x in rng.integers(1, read_len - 1, n_ind))
    w = window.copy()
    if error_rate > 0:
        errs = (rng.random(len(w)) < error_rate) & (w < 4)
        shift = rng.integers(1, 4, size=len(w)).astype(np.uint8)
        w[errs] = (w[errs] + shift[errs]) % 4
    while len(out) < read_len and i < len(w):
        if len(out) in events and i > 0:
            events.discard(len(out))
            m = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                i += m
            else:
                for _ in range(m):
                    out.append(int(rng.integers(0, 4)))
            continue
        out.append(int(w[i]))
        i += 1
    while len(out) < read_len:
        out.append(int(rng.integers(0, 4)))
    return np.array(out[:read_len], dtype=np.uint8)
