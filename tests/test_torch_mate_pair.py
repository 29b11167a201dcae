"""tpubwa_torch on mate-pair libraries (tpubwa_torch/tools/mate_pairs.py:
Nextera-style outward-facing pairs, inserts of 1.5-10 kbp) at 2x150 on a
120 kbp random world:

  * unfractionated inserts (uniform over 1.5-10 kbp) with FR paired-end
    contamination, rescue pairs and junction reads: RF and FR both live
    in pestat, and the RF rescue window gives K2 a target of T > 14,336,
    past what the kernel's K=5 register instance once held in shared
    memory;
  * a gel-selected library (3,000 +- 300) with rescue pairs: RF alone;
through Aligner(..., device="cpu"): SAM byte-equal to
tpubwa.pipeline.Aligner and to the oracle, with equal stats and no rescue
result missing. The insert histogram and the rescue tasks are recorded:
every task's window is at most what tools/mate_pairs.py::pestat (a mirror
of native/pe.cpp) gives its orientation, and most are exactly that, so
the mirror that chip_smoke.py prints is held to the native code. The
2x300 case is tests/test_torch_mate_pair_300.py.
"""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_long_pe import run_pe
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.ops import sw_local
from tpubwa_torch.pair import rescue
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import mate_pairs as mp

GENOME = 120_000
PAIRS = 40          # pairs a batch (one shape for the reference's compiles)
RESCUED = 6         # ... of them rescue pairs
# the register instances' old bound (row maxima in shared memory), and
# the generic instance's at Q = 300, both rounded to the rescue's 256
OLD_T = {150: 14336, 300: 13056}
# case -> (read length, mate_pairs keywords, simulator seed)
CASES = {
    "unfractionated": (150, dict(profile="unfractionated", fr_share=0.3,
                                 junction_share=0.05), 71),
    "gel": (150, dict(profile="gel", mean=3000, sd=300, fr_share=0.0), 72),
    "unfractionated300": (300, dict(profile="unfractionated",
                                    fr_share=0.3), 73),
}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1717)
    genome = dna.decode(rng.integers(0, 4, GENOME).astype(np.uint8))
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return (Aligner(idx, device="cpu"), JAligner(jidx),
            dna.encode(genome))


@pytest.fixture
def record(world, monkeypatch):
    """The (Q, T, want_sub) of every K2 call, and the insert histogram
    and rescue tasks of every PE batch, made while the test runs."""
    aln = world[0]
    k2, hists, tasks = [], [], []
    real_k2, real_h, real_t = rescue.ksw_local, aln._pe_hist, aln._pe_tasks

    def rec_k2(*args, want_sub, **kw):
        k2.append((args[0].shape[1], args[2].shape[1], want_sub))
        return real_k2(*args, want_sub=want_sub, **kw)

    def rec_hist(ctx):
        hists.append(real_h(ctx))
        return hists[-1]

    def rec_tasks(ctx):
        tasks.append(real_t(ctx))
        return tasks[-1]
    monkeypatch.setattr(rescue, "ksw_local", rec_k2)
    monkeypatch.setattr(aln, "_pe_hist", rec_hist)
    monkeypatch.setattr(aln, "_pe_tasks", rec_tasks)
    return k2, hists, tasks


def case_batch(fwd, name: str):
    L, kw, seed = CASES[name]
    return mp.batch(fwd, PAIRS, L, seed, rescue=RESCUED, **kw)


def run_case(world, record, name: str):
    """The case's batch through both packages and the oracle; returns
    the port's SAM lines (fields), pestat's four orientations and the
    recorded K2 calls, after checking every rescue task's window against
    pestat and the forward call's T against rescue_T."""
    aln, jaln, fwd = world
    L = CASES[name][0]
    sam = run_pe(aln, jaln, case_batch(fwd, name))
    k2, hists, tasks = record
    assert len(hists) == len(tasks) == 1 and aln.stats["rescue_tasks"] > 0
    pes = mp.pestat(hists[0], aln.opt.max_ins)
    t = tasks[0]
    wlen, dirs = t[:, 6] - t[:, 5], t[:, 3]
    want = np.array([mp.window(pes[d], L) for d in dirs])
    assert (wlen <= want).all() and (wlen == want).mean() > 0.5
    fwd_calls = [(q, T) for q, T, s in k2 if s]
    assert fwd_calls == [(L, mp.rescue_T(pes, L))]
    return [f.split("\t") for f in sam.splitlines()], pes, k2


def live(pes) -> set:
    return {r["orientation"] for r in pes if not r["failed"]}


def test_unfractionated_with_contamination(world, record):
    rows, pes, k2 = run_case(world, record, "unfractionated")
    assert live(pes) == {"RF", "FR"}
    # K2 past the register instance's old bound, K=5, both passes
    assert max(T for _, T, _ in k2) > OLD_T[150]
    assert {sw_local.kernel_instance(q) for q, _, _ in k2} == {5}
    assert {s for _, _, s in k2} == {True, False}
    # rescued mates pair properly; junction reads split into supplementary
    resc = [f for f in rows if f[0].startswith("mpr_")]
    assert len(resc) == 2 * RESCUED and all(int(f[1]) & 0x2 for f in resc)
    assert any(int(f[1]) & 0x800 for f in rows)
    assert any("SA:Z" in "\t".join(f) for f in rows if "_j" in f[0])


def test_gel_library(world, record):
    rows, pes, k2 = run_case(world, record, "gel")
    assert live(pes) == {"RF"}
    r = pes[mp.ORIENTATIONS.index("RF")]
    assert 1000 < r["low"] < 3000 < r["high"] < 5000
    resc = [f for f in rows if f[0].startswith("mpr_")]
    assert all(int(f[1]) & 0x2 for f in resc)
    # RF pairs properly paired, outward: the reverse read has the lower
    # coordinate; TLEN is the distance of the reads' 5' ends plus one
    # [bwa: mem_aln2sam], here the insert less both reads plus two
    mpairs = [f for f in rows if f[0].startswith("mp_")
              and int(f[1]) & 0x2 and not int(f[1]) & 0x900]
    assert len(mpairs) >= PAIRS
    for f in mpairs:
        ins = int(f[0].split("_")[3])
        assert abs(int(f[8])) == ins - 2 * 150 + 2
        assert (int(f[1]) & 0x10 != 0) == (int(f[8]) > 0)


def test_builder_is_deterministic_and_shaped(world):
    fwd = world[2]
    a, b, c = (mp.mate_pairs(fwd, 60, 150, s, fr_share=0.2, rescue=5,
                             junction_share=0.1) for s in (3, 3, 4))
    assert len(a) == 120 and a == b and a != c
    names = [r.name for r in a[::2]]
    assert all(r.name == s.name for r, s in zip(a[::2], a[1::2]))
    assert sum(n.startswith("fr_") for n in names) == 12
    assert sum(n.startswith("mpr_") for n in names) == 5
    assert any("_j" in n for n in names)
    # an RF pair on the forward strand: read 1 the head reverse-
    # complemented, read 2 the tail
    for r1, r2 in zip(a[::2], a[1::2]):
        kind, _, pos, ins, strand = r1.name.split("_")[:5]
        if kind == "mp" and strand == "f" and "_j" not in r1.name:
            pos, ins = int(pos), int(ins)
            head = dna.decode(dna.revcomp(fwd[pos:pos + 150]))
            tail = dna.decode(fwd[pos + ins - 150:pos + ins])
            assert sum(x != y for x, y in zip(r1.seq, head)) <= 8
            assert sum(x != y for x, y in zip(r2.seq, tail)) <= 8


@pytest.mark.parametrize("profile", mp.PROFILES)
def test_insert_profiles(profile):
    x = mp.insert_sizes(20000, profile, np.random.default_rng(5),
                        mean=8000, sd=1000)
    if profile == "gel":
        assert abs(x.mean() - 8000) < 30 and abs(x.std() - 1000) < 30
    elif profile == "unfractionated":
        assert x.min() >= 1500 and x.max() <= 10000
        assert abs(np.median(x) - 5750) < 100
    else:
        short = x <= 1500
        assert abs(short.mean() - 0.3) < 0.02
        assert x[short].min() >= 1000 and x[~short].min() >= 9000
