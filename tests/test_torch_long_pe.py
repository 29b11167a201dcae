"""tpubwa_torch on long Illumina reads, paired-end at 2x250 and 2x300 bp
and single-end at 300 bp, on a 30 kbp random world:

  * 2x250 (inserts 550 +- 50) and 2x300 (inserts 650 +- 60): simulated
    pairs and pairs whose second mate, an error every 7 bases, only the
    mate rescue places; one batch a read length;
  * 300 bp single-end reads;
through Aligner(..., device="cpu"): SAM byte-equal to
tpubwa.pipeline.Aligner and to the oracle, with equal stats and no rescue
result missing from the injected results.

Both kernels are wrapped to record the widths of their calls (Q, T), so
that each case shows the instance its batch takes on a card: at 2x300
and 300 bp SE every K1 call and both K2 passes are wider than any
register instance (the generic, shared-memory instances); at 2x250 both
kernels take their K=8 register instance.
"""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_contigs_pe import PE_STATS
from test_torch_contigs_se import SHARED_STATS
from test_torch_pipeline_pe import assert_same_sam
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.extend import worker
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.ops import sw, sw_local
from tpubwa_torch.pair import rescue
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import long_pairs as lp

# read length -> (insert mean, sd, simulator seed, rescue seed)
PE_CASES = {250: (550, 50, 51, 53), 300: (650, 60, 52, 54)}
PAIRS = 20          # simulated pairs a case
RESCUED = 3         # ... and heavy-error pairs beside them


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1515)
    genome = dna.decode(rng.integers(0, 4, 30000).astype(np.uint8))
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return (Aligner(idx, device="cpu"), JAligner(jidx),
            dna.encode(genome))


@pytest.fixture
def widths(monkeypatch):
    """The (Q, T) of every K1 call and the (Q, T, want_sub) of every K2
    call made while the test runs."""
    k1, k2 = [], []
    real1, real2 = worker.ksw_extend, rescue.ksw_local

    def rec1(*args, **kw):
        k1.append((args[0].shape[1], args[2].shape[1]))
        return real1(*args, **kw)

    def rec2(*args, want_sub, **kw):
        k2.append((args[0].shape[1], args[2].shape[1], want_sub))
        return real2(*args, want_sub=want_sub, **kw)
    monkeypatch.setattr(worker, "ksw_extend", rec1)
    monkeypatch.setattr(rescue, "ksw_local", rec2)
    return k1, k2


def reset(*alns):
    for a in alns:
        a.stats = {"reads": 0, "fallback_reads": 0}


def run_pe(aln, jaln, batch, id0=0) -> str:
    """align_pe in both packages from fresh stats; the port's SAM held to
    the oracle's and the reference's, the shared stats equal, no rescue
    result missing. Returns the port's SAM."""
    reset(aln, jaln)
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    got = aln.align_pe(batch, id0=id0)
    assert lib.tb_rescue_miss_count() == 0
    assert got.count("\n") >= batch.n
    assert_same_sam(got, aln.oracle.align_pe(batch, aln.opt, id0=id0)[0],
                    "the oracle")
    assert_same_sam(got, jaln.align_pe(batch, id0=id0), "tpubwa.Aligner")
    for k in PE_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    return got


def pe_batch(fwd, read_len: int):
    mean, sd, seed, rseed = PE_CASES[read_len]
    recs = fastx.simulate_reads(fwd, PAIRS, read_len=read_len, paired=True,
                                error_rate=0.01, seed=seed,
                                insert_mean=mean, insert_std=sd)
    return fastx.batch_reads(
        recs + lp.rescue_pairs(fwd, RESCUED, read_len, rseed, mean))


def instances(k1, k2):
    """The K1 instances and the K2 instances of each pass (forward with
    want_sub, reverse without) that the recorded widths take."""
    return ({sw.kernel_instance(q) for q, _ in k1},
            {s: {sw_local.kernel_instance(q) for q, _, w in k2 if w == s}
             for s in (True, False)})


@pytest.mark.parametrize("read_len", sorted(PE_CASES))
def test_long_pe_equals_reference_and_oracle(world, widths, read_len):
    aln, jaln, fwd = world
    got = run_pe(aln, jaln, pe_batch(fwd, read_len))
    assert aln.stats["rescue_tasks"] > 0
    k1, k2 = widths
    want = 8 if read_len == 250 else 0      # K=8 register, or generic
    assert instances(k1, k2) == ({want}, {True: {want}, False: {want}})
    assert {q for q, _ in k1} == {q for q, _, _ in k2} == {read_len}
    # the heavy-error mates are placed by the rescue, properly paired
    resc = [l.split("\t") for l in got.splitlines() if l.startswith("resc")]
    assert len(resc) == 2 * RESCUED
    assert all(int(f[1]) & 0x2 for f in resc)


def test_se_300_equals_reference_and_oracle(world, widths):
    aln, jaln, fwd = world
    # as many reads as the 2x300 batch: the reference compiles one shape
    batch = fastx.batch_reads(fastx.simulate_reads(
        fwd, 2 * (PAIRS + RESCUED), read_len=300, error_rate=0.01,
        indel_rate=0.001, seed=55))
    reset(aln, jaln)
    got = aln.align_se(batch, id0=0)
    assert_same_sam(got, aln.oracle.align_se(batch, aln.opt, id0=0),
                    "the oracle")
    assert_same_sam(got, jaln.align_se(batch, id0=0), "tpubwa.Aligner")
    for k in SHARED_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    k1, k2 = widths
    assert k1 and not k2
    assert {sw.kernel_instance(q) for q, _ in k1} == {0}
