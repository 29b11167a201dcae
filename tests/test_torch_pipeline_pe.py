"""tpubwa_torch PE pipeline: SAM byte-equal to tpubwa.Aligner.align_pe and
to the scalar oracle's align_pe.

The worlds of tests/test_pipeline_pe.py on the CPU (plain pairs; a
heavy-error mate and a junk mate; pairs in a planted repeat; a batch whose
rescue really runs with no window missing from the injected results; the
stream against align_pe), plus a case with explicit small caps in which
reads overflow every device tier and take their regions from the oracle.
"""
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
    rng = np.random.default_rng(999)
    g = rng.integers(0, 4, 25000).astype(np.uint8)
    g[12000:12200] = g[4000:4200]
    genome = dna.decode(g)
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, idx, Aligner(idx, device="cpu"), dna.encode(genome)


@pytest.fixture(scope="module")
def jaln(world):
    return JAligner(world[0])


def heavy_error_mates(fwd, recs, starts, step, seed):
    """Append pairs whose second mate carries an error every `step` bases:
    seeding fails on it, the rescue alignment finds it."""
    rng = np.random.default_rng(seed)
    for k, p in enumerate(starts):
        frag = fwd[p:p + 300]
        r2 = dna.revcomp(frag[-100:]).copy()
        for q in range(0, 100, step):
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        recs.append(fastx.FastxRecord(f"resc{k}", dna.decode(frag[:100])))
        recs.append(fastx.FastxRecord(f"resc{k}", dna.decode(r2)))


def plain_pairs(fwd):
    return fastx.simulate_reads(fwd, 48, read_len=100, paired=True,
                                error_rate=0.01, seed=1, insert_mean=320,
                                insert_std=25)


def rescue_and_junk(fwd):
    recs = fastx.simulate_reads(fwd, 40, read_len=100, paired=True,
                                error_rate=0.02, seed=2)
    heavy_error_mates(fwd, recs, (8000,), 6, 3)
    rng = np.random.default_rng(4)
    recs.append(fastx.FastxRecord("junk", dna.decode(fwd[2000:2100])))
    recs.append(fastx.FastxRecord("junk", dna.decode(
        rng.integers(0, 4, 100).astype(np.uint8))))
    return recs


def repeat_pairs(fwd):
    recs = fastx.simulate_reads(fwd, 30, read_len=100, paired=True, seed=4,
                                insert_mean=300, insert_std=20)
    for i, p in enumerate((12000, 12050, 4020)):   # the planted duplicate
        frag = fwd[p:p + 280]
        recs.append(fastx.FastxRecord(f"rep{i}", dna.decode(frag[:100])))
        recs.append(fastx.FastxRecord(
            f"rep{i}", dna.decode(dna.revcomp(frag[-100:]))))
    return recs


def rescue_pairs(fwd):
    recs = fastx.simulate_reads(fwd, 60, read_len=100, paired=True,
                                error_rate=0.01, seed=5, insert_mean=320,
                                insert_std=25)
    heavy_error_mates(fwd, recs, (3000, 9000, 15000), 7, 11)
    return recs


def assert_same_sam(got: str, want: str, who: str):
    g, w = got.split("\n"), want.split("\n")
    for i, (x, y) in enumerate(zip(g, w)):
        assert x == y, f"line {i} differs from {who}:\nport: {x}\nwant: {y}"
    assert len(g) == len(w)


@pytest.mark.parametrize("make", [plain_pairs, rescue_and_junk,
                                  repeat_pairs])
def test_pe_matches_reference_and_oracle(world, jaln, make):
    _, _, aln, fwd = world
    batch = fastx.batch_reads(make(fwd))
    got = aln.align_pe(batch, id0=0)
    assert got.count("\n") >= batch.n
    assert_same_sam(got, aln.oracle.align_pe(batch, aln.opt, id0=0)[0],
                    "the oracle")
    assert_same_sam(got, jaln.align_pe(batch, id0=0), "tpubwa.Aligner")


def test_pe_rescue_really_runs(world, jaln):
    """The batched rescue must (a) generate tasks for a batch with a
    rescuable mate and (b) cover every window the scalar replay needs:
    zero misses in the injected results."""
    _, _, aln, fwd = world
    batch = fastx.batch_reads(rescue_pairs(fwd))
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    aln.stats.pop("rescue_tasks", None)
    reads0 = aln.stats["reads"]
    got = aln.align_pe(batch, id0=3)
    assert aln.stats["rescue_tasks"] > 0
    assert lib.tb_rescue_miss_count() == 0
    assert aln.stats["reads"] == reads0 + batch.n     # counted once
    assert_same_sam(got, aln.oracle.align_pe(batch, aln.opt, id0=3)[0],
                    "the oracle")
    assert_same_sam(got, jaln.align_pe(batch, id0=3), "tpubwa.Aligner")
    # the rescued mates are placed: proper-pair flag on both records
    for line in got.split("\n"):
        if line.startswith("resc"):
            assert int(line.split("\t")[1]) & 0x2, line


def test_pe_stream_matches_align_pe(world, jaln):
    _, _, aln, fwd = world
    recs = fastx.simulate_reads(fwd, 64, read_len=100, paired=True,
                                error_rate=0.01, seed=6, insert_mean=320,
                                insert_std=25)
    batches = [fastx.batch_reads(recs[i:i + 32]) for i in range(0, 128, 32)]
    got = list(aln.align_pe_stream(batches, id0=5))
    assert len(got) == len(batches)
    n = 5
    for b, sam in zip(batches, got):
        assert_same_sam(sam, aln.align_pe(b, id0=n), "align_pe")
        assert_same_sam(sam, aln.oracle.align_pe(b, aln.opt, id0=n)[0],
                        "the oracle")
        n += b.n // 2
    assert "".join(got) == "".join(jaln.align_pe_stream(batches, id0=5))
    # explicit pair numbering with a gap, and an empty stream
    two = list(aln.align_pe_stream([(batches[0], 5), (batches[2], 37)]))
    assert two == [got[0], got[2]]
    assert list(aln.align_pe_stream([])) == []


def test_pe_reads_overflowing_every_tier_use_oracle_regions(world):
    """Explicit small caps: the repeat pairs overflow tier 1, too few of
    them for the big-caps tiers to be worth a device call, so their
    regions come from the oracle's regs_pre and the SAM is unchanged."""
    jidx, idx, _, fwd = world
    caps = dict(max_smems=4, max_seeds=8, max_chains=1, max_regs=1)
    aln = Aligner(idx, device="cpu", **caps)
    batch = fastx.batch_reads(repeat_pairs(fwd))
    got = aln.align_pe(batch, id0=0)
    assert 0 < aln.stats["fallback_reads"] < aln.TIER3_MIN
    assert aln.stats["reads"] == batch.n
    assert_same_sam(got, aln.oracle.align_pe(batch, aln.opt, id0=0)[0],
                    "the oracle")
    assert_same_sam(got, JAligner(jidx, **caps).align_pe(batch, id0=0),
                    "tpubwa.Aligner")
