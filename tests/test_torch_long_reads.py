"""tpubwa_torch on 250 bp reads (BASELINE config 5 at a small size), the
counterpart of tests/test_long_reads.py: the same 30 kbp world (seed 777)
and the same four cases — simulated reads, chimeric reads split into a
primary and a supplementary line (0x800, hard clips), adapter-like 3'
tails soft-clipped, and SA:Z tags on split reads. The four cases are
aligned as one batch (one compile of the reference): the port on the CPU
is byte-equal to the oracle and to tpubwa.Aligner, and each case's lines
have the reference test's structure."""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(777)
    genome = dna.decode(rng.integers(0, 4, 30000).astype(np.uint8))
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, Aligner(idx, device="cpu"), dna.encode(genome)


def simulated(fwd):
    return fastx.simulate_reads(fwd, 24, read_len=250, error_rate=0.02,
                                seed=1)


def chimeras(fwd, seed, n, cut, tag):
    """Reads joining two loci: cut(rng) bases of one, the rest of 250 from
    another (tests/test_long_reads.py's construction)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        p1 = int(rng.integers(0, 25000))
        p2 = int(rng.integers(0, 25000))
        c = cut(rng)
        seq = np.concatenate([fwd[p1:p1 + c], fwd[p2:p2 + 250 - c]])
        recs.append(fastx.FastxRecord(f"{tag}{i}", dna.decode(seq)))
    return recs


def split_reads(fwd):
    return chimeras(fwd, 2, 8, lambda rng: int(rng.integers(100, 150)),
                    "split")


def sa_reads(fwd):
    return chimeras(fwd, 5, 4, lambda rng: 120, "sa")


def adapter_reads(fwd):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(6):
        p = int(rng.integers(0, 25000))
        junk = rng.integers(0, 4, 30).astype(np.uint8)
        recs.append(fastx.FastxRecord(
            f"ad{i}", dna.decode(np.concatenate([fwd[p:p + 220], junk]))))
    return recs


@pytest.fixture(scope="module")
def cases(world):
    """The four cases as one batch: (records, the port's SAM)."""
    _, aln, fwd = world
    recs = simulated(fwd) + split_reads(fwd) + adapter_reads(fwd) + \
        sa_reads(fwd)
    return recs, aln.align_se(fastx.batch_reads(recs), id0=0)


def by_name(sam, prefix):
    """The SAM lines of the reads whose names start with prefix, by read."""
    out = {}
    for line in sam.strip().split("\n"):
        f = line.split("\t")
        if f[0].startswith(prefix):
            out.setdefault(f[0], []).append(f)
    return out


def test_250bp_device_matches_oracle(world, cases):
    _, aln, _ = world
    recs, got = cases
    assert got == aln.oracle.align_se(fastx.batch_reads(recs), aln.opt,
                                      id0=0)
    assert len(by_name(got, "sim_")) == 24
    # the third cap bucket served the batch
    assert 1 << 30 in aln._packed


def test_250bp_split_reads_supplementary(cases):
    """Chimeric 250 bp reads -> primary + supplementary (0x800, hard
    clips)."""
    n_with_supp = 0
    for name, rows in by_name(cases[1], "split").items():
        if len(rows) >= 2:
            prim = [r for r in rows if not int(r[1]) & 0x800]
            supp = [r for r in rows if int(r[1]) & 0x800]
            assert len(prim) == 1
            n_with_supp += bool(supp)
            for s in supp:
                assert "H" in s[5] and "S" not in s[5]
            assert "H" not in prim[0][5]
    assert n_with_supp >= 6


def test_soft_clip_adapterish(cases):
    """Reads with 30 bp of foreign sequence at the 3' end soft-clip it."""
    rows = [f for r in by_name(cases[1], "ad").values() for f in r]
    assert len({f[0] for f in rows}) == 6
    for f in rows:
        if int(f[1]) & (0x800 | 0x100):
            continue
        assert f[5].endswith("S") or (f[5][0].isdigit() and "S" in f[5]), \
            f[5]


def test_supplementary_sa_tag(cases):
    """Every non-secondary line of a split read carries SA:Z listing the
    other non-secondary lines [bwa: mem_aln2sam SA block]."""
    n_sa = 0
    for name, rows in by_name(cases[1], "sa").items():
        nonsec = [r for r in rows if not int(r[1]) & 0x100]
        if len(nonsec) < 2:
            continue
        n_sa += 1
        for r in nonsec:
            tags = {t.split(":", 1)[0]: t for t in r[11:]}
            assert "SA" in tags, f"{name}: missing SA on flag {r[1]}"
            entries = [e for e in tags["SA"].split(":", 2)[2].split(";")
                       if e]
            assert len(entries) == len(nonsec) - 1
            others = {(o[2], o[3], "-" if int(o[1]) & 0x10 else "+")
                      for o in nonsec if o is not r}
            assert {tuple(e.split(",")[:3]) for e in entries} == others
    assert n_sa >= 3


def test_four_cases_equal_tpubwa(world, cases):
    jidx, _, _ = world
    recs, got = cases
    assert got == JAligner(jidx).align_se(fastx.batch_reads(recs), id0=0)
