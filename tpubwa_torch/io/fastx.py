"""FASTA / FASTQ readers, read batches and a deterministic synthetic read
simulator.

Replacement for the reference's HDFS/Avro input layer
(``FASTQLocalFileLoader`` — SURVEY.md §2.1): reads come from local FASTQ
files (plain or ``.gz``) and become flat numpy batches (padded, bucketed by
length) that are copied to the device as one tensor per batch.
"""
from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path
from typing import Iterator

import numpy as np

from ..utils import dna


@dataclasses.dataclass
class FastxRecord:
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None


def _open(path: str | Path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path: str | Path) -> list[tuple[str, str]]:
    """Returns [(name, sequence)] for the whole file: the name is the first
    word of the header line; blank lines are skipped."""
    out: list[tuple[str, str]] = []
    name, chunks = None, []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            out.append((name, "".join(chunks)))
    return out


def iter_fastq(path: str | Path) -> Iterator[FastxRecord]:
    """Four-line FASTQ records; the name is the header's first word, the
    rest of the header is the comment."""
    with _open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                return
            hdr = hdr.rstrip("\n")
            seq = f.readline().rstrip("\n")
            f.readline()  # '+'
            qual = f.readline().rstrip("\n")
            fields = hdr[1:].split(None, 1)
            yield FastxRecord(name=fields[0], seq=seq, qual=qual,
                              comment=fields[1] if len(fields) > 1 else None)


def write_fastq(path: str | Path, records: list[FastxRecord]) -> None:
    """Writes records as FASTQ; a record without qualities gets 'I's."""
    with open(path, "w") as f:
        for r in records:
            q = r.qual if r.qual is not None else "I" * len(r.seq)
            f.write(f"@{r.name}\n{r.seq}\n+\n{q}\n")


@dataclasses.dataclass
class ReadBatch:
    """Fixed-shape read batch: the unit shipped to the device.

    seqs:  (n, max_len) uint8 codes in {0..4}, padded with 4 (N)
    lens:  (n,) int32 true lengths
    names: python list (host-side only; never crosses to device)
    quals: list[str] (host-side only)
    """

    seqs: np.ndarray
    lens: np.ndarray
    names: list[str]
    quals: list[str | None]

    @property
    def n(self) -> int:
        return len(self.names)


def batch_reads(records: list[FastxRecord], max_len: int | None = None) -> ReadBatch:
    n = len(records)
    if max_len is None:
        max_len = max((len(r.seq) for r in records), default=0)
    seqs = np.full((n, max_len), 4, dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    names, quals = [], []
    for i, r in enumerate(records):
        codes = dna.encode(r.seq)
        seqs[i, : len(codes)] = codes
        lens[i] = len(codes)
        names.append(r.name)
        quals.append(r.qual)
    return ReadBatch(seqs=seqs, lens=lens, names=names, quals=quals)


# ---------------------------------------------------------------------------
# Deterministic read simulator (wgsim-style) for tests and benchmarks.
# The reference had no in-tree simulator; SURVEY.md §4 calls for one.
# ---------------------------------------------------------------------------

def simulate_reads(
    ref: np.ndarray,
    n: int,
    read_len: int = 100,
    error_rate: float = 0.0,
    indel_rate: float = 0.0,
    seed: int = 0,
    paired: bool = False,
    insert_mean: int = 350,
    insert_std: int = 35,
) -> list[FastxRecord]:
    """Sample reads (optionally pairs, FR orientation) from an encoded
    reference.

    Read names encode the truth locus: ``sim_<i>_<pos>_<strand>`` (pairs:
    ``sim_<i>_<pos>_<insert>``, both mates under one name) so tests can
    check mapping positions without an external truth file.
    """
    rng = np.random.default_rng(seed)
    L = len(ref)
    slack = 8 + int(np.ceil(4 * read_len * indel_rate)) if indel_rate > 0 \
        else 0
    out: list[FastxRecord] = []
    for i in range(n):
        if paired:
            ins = int(np.clip(rng.normal(insert_mean, insert_std),
                              2 * read_len, L))
            pos = int(rng.integers(0, L - ins - slack + 1))
            frag = ref[pos : pos + ins + slack]
            r1 = _mutate(frag[: read_len + slack], rng, read_len,
                         error_rate, indel_rate)
            r2 = _mutate(dna.revcomp(frag[:ins])[: read_len + slack], rng,
                         read_len, error_rate, indel_rate)
            out.append(FastxRecord(f"sim_{i}_{pos}_{ins}", dna.decode(r1)))
            out.append(FastxRecord(f"sim_{i}_{pos}_{ins}", dna.decode(r2)))
            continue
        strand = int(rng.integers(0, 2))
        pos = int(rng.integers(0, L - read_len - slack + 1))
        r = ref[pos : pos + read_len + slack]
        if strand:
            r = dna.revcomp(r)
        r = _mutate(r, rng, read_len, error_rate, indel_rate)
        # truth = leftmost consumed reference base (forward coords):
        # a reverse read consumes the window from its high end, so
        # without indels it covers [pos+slack, pos+read_len+slack)
        tpos = pos + slack if strand else pos
        out.append(FastxRecord(f"sim_{i}_{tpos}_{strand}", dna.decode(r)))
    return out


def _mutate(window: np.ndarray, rng: np.random.Generator, read_len: int,
            error_rate: float, indel_rate: float) -> np.ndarray:
    """Substitutions + (optional) 1-3bp indels; returns exactly read_len
    bases drawn from a window of read_len + slack."""
    r = window[:read_len].copy()
    if error_rate > 0:
        errs = (rng.random(read_len) < error_rate) & (r < 4)
        shift = rng.integers(1, 4, size=read_len).astype(np.uint8)
        r[errs] = (r[errs] + shift[errs]) % 4
    n_ind = int(rng.binomial(read_len, indel_rate)) if indel_rate > 0 else 0
    if n_ind == 0:
        return r
    # slow path (rare): re-walk the window applying indel events
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
                i += m                        # deletion: skip ref bases
            else:
                for _ in range(m):            # insertion: random bases
                    out.append(int(rng.integers(0, 4)))
            continue
        out.append(int(w[i]))
        i += 1
    while len(out) < read_len:
        out.append(int(rng.integers(0, 4)))
    return np.array(out[:read_len], dtype=np.uint8)
