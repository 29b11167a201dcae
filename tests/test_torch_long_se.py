"""tpubwa_torch on long single-end reads, 1-4 kbp, on a 40 kbp random
world, under bwa's default flags and the pacbio and ont2d sets
(tools/option_sets.py, bwa's `mem -x` presets for such reads):

  * 1,024 bp HiFi-like reads (0.5% errors) at the defaults;
  * 4,000 bp reads, wider than the 3,584 bp the generic K1 instance once
    held in a block's shared memory: CLR-like (12% errors, two thirds
    indels) at the defaults and at pacbio, ONT-like (10%, indel-heavy) at
    ont2d;
  * a mixed batch of 1-4 kbp CLR-like reads at pacbio (one full-width
    call: padded to its longest read, it does not split by length);
each batch with a share of chimeric reads (two loci in one read), from
tools/long_reads.py; through Aligner(..., device="cpu"): SAM byte-equal to
tpubwa.pipeline.Aligner and to the oracle, with equal stats; and through
the port's command line at each of the three flag sets, the file
byte-equal to the header and the oracle's SAM.

K1 is wrapped to record the query width of every call, so that each case
shows the widths a card would launch: the whole read width in one call
(4,000), or a length bucket's width. Faults F12 (the seeding walk's
off-diagonal windows at long widths) and F13 (the extension's seed
visiting order at tier 3's caps) are held by tests of their own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_contigs_se import SHARED_STATS
from test_torch_options_se import reference_options
from test_torch_pipeline_pe import assert_same_sam
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch import cli
from tpubwa_torch.extend import worker
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.ops import sw
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.seed import lut
from tpubwa_torch.tools import long_reads, option_sets

READS = 4           # a batch: under tier 3's gate of 8, as the reference's
CHIMERA = 0.3       # a chimeric read in most batches


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(1616)
    genome = dna.decode(rng.integers(0, 4, 40000).astype(np.uint8))
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return idx, jidx, dna.encode(genome)


@pytest.fixture
def widths(monkeypatch):
    """The query width of every K1 call made while the test runs."""
    qs = []
    real = worker.ksw_extend

    def rec(*args, **kw):
        qs.append(args[0].shape[1])
        return real(*args, **kw)
    monkeypatch.setattr(worker, "ksw_extend", rec)
    return qs


def run_se(world, name, batch) -> str:
    """align_se in both packages at option set ``name`` (bwa's defaults
    for None): the port's SAM held to the oracle's and the reference's,
    the shared stats equal. Returns the port's SAM."""
    idx, jidx, _ = world
    if name:
        aln = Aligner(idx, option_sets.options(name), device="cpu")
        jaln = JAligner(jidx, reference_options(name))
    else:
        aln, jaln = Aligner(idx, device="cpu"), JAligner(jidx)
    got = aln.align_se(batch, id0=0)
    assert got.count("\n") >= batch.n
    assert_same_sam(got, aln.oracle.align_se(batch, aln.opt, id0=0),
                    "the oracle")
    assert_same_sam(got, jaln.align_se(batch, id0=0), "tpubwa.Aligner")
    for k in SHARED_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    assert aln.stats["reads"] == batch.n
    return got


@pytest.mark.parametrize("name,length,profile,seed", [
    (None, 1024, "hifi", 71), (None, 4000, "clr", 72),
    ("pacbio", 4000, "clr", 73), ("ont2d", 4000, "ont", 74)])
def test_long_se_equals_reference_and_oracle(world, widths, name, length,
                                             profile, seed):
    recs = long_reads.long_reads(world[2], READS, profile, seed,
                                 length=length, chimera=CHIMERA)
    got = run_se(world, name, fastx.batch_reads(recs))
    assert set(widths) == {length}          # one call width: the read's
    assert sw.kernel_instance(length) == 0  # the generic instance
    assert len(got.splitlines()) >= READS


def test_mixed_long_se(world, widths):
    """Reads of 1-4 kbp in one batch, padded to its longest read as the
    command line pads a batch: the longest read's 64-lane bucket is the
    batch's width, so align_se runs it as one full-width call, not by
    length bucket (a batch padded wider splits; phase 26 (b) of
    chip_smoke.py runs that on the card: here each bucket pads to 128
    rows, which the CPU's plain kernels take many minutes over)."""
    recs = long_reads.long_reads(world[2], READS, "clr", 84, lo=1000,
                                 hi=4000, median=2000, chimera=CHIMERA)
    lens = sorted(len(r.seq) for r in recs)
    assert lens[0] < 2000 and lens[-1] > 3584
    run_se(world, "pacbio", fastx.batch_reads(recs))
    assert len({-(-n // Aligner.BUCKET) for n in lens}) == 3
    assert set(widths) == {lens[-1]}


@pytest.mark.parametrize("name", [None, "pacbio", "ont2d"])
def test_cli_on_long_reads(world, tmp_path, name):
    """``python -m tpubwa_torch align`` on 1-2.5 kbp reads at bwa's
    default flags and at the pacbio and ont2d sets: the file byte-equal
    to the header and the oracle's SAM at the same options."""
    idx, _, fwd = world
    npz, fq, out = tmp_path / "g.npz", tmp_path / "r.fq", tmp_path / "o.sam"
    idx.save(npz)
    fastx.write_fastq(fq, long_reads.long_reads(
        fwd, 3, "ont" if name == "ont2d" else "clr", 77, lo=1000, hi=2500,
        median=1500, chimera=CHIMERA))
    flags = list(option_sets.SETS[name]) if name else []
    assert cli.main(["align", str(npz), str(fq), "-o", str(out),
                     "--platform", "cpu", *flags]) == 0
    opt = option_sets.options(name) if name else MemOptions()
    aln = Aligner(idx, opt, device="cpu")
    batch = fastx.batch_reads(list(fastx.iter_fastq(fq)))
    assert out.read_text() == aln.sam_header() + aln.oracle.align_se(
        batch, opt, id0=0)


def test_offdiag_windows_go_in_slices(world, monkeypatch):
    """F12: the seeding walk's off-diagonal fallback compared an L-wide
    text window for each of its B * L // offdiag_dense dense lanes at once
    (16 GiB of gather indices at 512 reads of 4,096 bp: out of memory on
    the card). The lanes now go through in slices of WINDOW_ELEMS // L
    lanes, with the same seeds."""
    idx, _, fwd = world
    batch = fastx.batch_reads(long_reads.long_reads(
        fwd, READS, "clr", 76, length=2000, chimera=CHIMERA))
    aln = Aligner(idx, device="cpu")
    seqs = torch.as_tensor(batch.seqs).to(torch.int32)
    lens = torch.as_tensor(batch.lens)
    whole = lut.collect_smems_lut(aln.didx, aln.lut, seqs, lens, aln.scfg)
    sizes = []
    real = lut.text_window_desc

    def rec(didx, end, W):
        sizes.append(end.shape[0] * W)
        return real(didx, end, W)
    monkeypatch.setattr(lut, "text_window_desc", rec)
    monkeypatch.setattr(lut, "WINDOW_ELEMS", 16 * 2000)
    sliced = lut.collect_smems_lut(aln.didx, aln.lut, seqs, lens, aln.scfg)
    # round 1 and each re-seeding walk: at least 256 dense lanes a walk
    assert len(sizes) >= 2 * 256 // 16 and max(sizes) <= 16 * 2000
    assert whole.keys() == sliced.keys()
    for k in whole:
        assert torch.equal(whole[k], sliced[k]), k


def reference_visit_order(seed_rank, len_s, stored, C, L):
    """tpubwa/extend/worker.py:148-152's seed visiting order, as it stands
    (an int32 key, then int64 once the slot term is added)."""
    S = seed_rank.shape[1]
    r, n = jnp.asarray(seed_rank.numpy()), jnp.asarray(len_s.numpy())
    key = r * (L + 1) * S + (L - n) * S + (S - 1 - jnp.arange(S)[None, :])
    key = jnp.where(jnp.asarray(stored.numpy()) & (r < C), key, 2**31 - 1)
    return np.asarray(jnp.argsort(key, axis=1))


@pytest.mark.parametrize("C,S,L,wraps", [(63, 288, 250, False),
                                         (64, 640, 12288, False),
                                         (512, 1280, 12288, True)])
def test_visit_order_key_does_not_wrap(C, S, L, wraps):
    """F13: the order the extension visits a read's seeds in (chain rank,
    then length descending, then slot descending) came from one int32 key,
    rank * (L + 1) * S + ..., which wraps from rank 137 on at tier 3's
    caps (C = 512 chains, S = 1280 seeds) and a 12,288-wide batch: on the
    card a 3,782 bp read of phase 26 (b), re-run by tier 3 at the batch's
    width with 169 chains, got a suboptimal score (XS) the oracle does not
    give. The key is int64 now. It equals the reference's order where the
    reference's key does not wrap."""
    rng = np.random.default_rng(C + L)
    B = 3
    seed_rank = torch.tensor(rng.integers(0, C + 1, (B, S)),
                             dtype=torch.int32)
    seed_rank[0] = torch.tensor(rng.integers(0, 8, S), dtype=torch.int32)
    len_s = torch.tensor(rng.integers(17, 60, (B, S)), dtype=torch.int32)
    stored = torch.tensor(rng.random((B, S)) < 0.9)
    order, n = worker.visit_order(seed_rank, len_s, stored, C, L)
    for b in range(B):
        visit = [s for s in range(S) if stored[b, s] and seed_rank[b, s] < C]
        want = sorted(visit, key=lambda s: (int(seed_rank[b, s]),
                                            -int(len_s[b, s]), -s))
        assert n[b] == len(visit)
        assert order[b, :n[b]].tolist() == want
        assert sorted(order[b].tolist()) == list(range(S))
    ref = reference_visit_order(seed_rank, len_s, stored, C, L)
    assert (ref[0] == order[0].numpy()).all()     # low ranks: no wrap
    assert (ref == order.numpy()).all() != wraps


def test_long_reads_simulator():
    """Lengths, strands, chimeras and error profiles of
    tools/long_reads.py, from its seed alone."""
    fwd = np.random.default_rng(3).integers(0, 4, 200_000).astype(np.uint8)
    rng = np.random.default_rng(0)
    lens = long_reads.read_lengths(4000, rng)
    assert lens.min() == 1000 and lens.max() == 12288
    assert 5500 < np.median(lens) < 6500
    recs = long_reads.long_reads(fwd, 200, "clr", 9, chimera=0.1)
    assert recs == long_reads.long_reads(fwd, 200, "clr", 9, chimera=0.1)
    names = [r.name for r in recs]
    assert 10 <= sum(n.startswith("lrc_") for n in names) <= 30
    plain = [n.split("_") for n in names if n.startswith("lr_")]
    assert {p[3] for p in plain} == {"0", "1"}
    assert all(len(r.seq) == 3000 for r in long_reads.long_reads(
        fwd, 8, "ont", 1, length=3000))
    tmpl = fwd[:100_000]
    for profile, (e, _, p_ins, p_del) in long_reads.PROFILES.items():
        r = long_reads.mutate(tmpl, np.random.default_rng(5), profile)
        # net length change: insertions less deletions
        assert abs(len(r) / len(tmpl) - 1 - e * (p_ins - p_del)) < 0.004
