"""tpubwa_torch on references of many contigs, single-end.

  * a 30 kbp world of 12 contigs (one shorter than a read, N runs at
    contig ends): simulated reads, reads that straddle every boundary on
    both strands, reads flush with contig starts and ends, and chimeric
    250 bp reads whose two parts lie on two contigs, through
    Aligner(..., device="cpu").align_se: SAM byte-equal to
    tpubwa.pipeline.Aligner and to the oracle, with equal stats;
  * a world of 2100 contigs of 300 bp: a region on contig 2048 or later
    does not fit the packed row's 11-bit contig field, so its read
    overflows tier 1, runs tier 2 and tier 3 and falls to the oracle, in
    both packages alike;
  * tpubwa_torch/tools/contig_layouts.py: the grch38 and hs38dh layouts
    (195 and 3366 contigs) cover the text exactly, and a one-sequence
    index re-annotated with a layout equals build_index of the same
    N-free text cut into the layout's records, array for array.
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
from tpubwa_torch.tools import contig_layouts as cl
from tpubwa_torch.utils import genome

# contig lengths of the small world (30 kbp; the third is 60 bp) and its
# N runs: (contig, at its start or end, length)
SMALL_LENGTHS = (4200, 3100, 60, 2900, 3600, 1900, 2500, 2800, 1500, 2200,
                 2340, 2900)
SMALL_NS = ((1, "end", 50), (3, "start", 40), (7, "end", 120),
            (9, "start", 30), (11, "end", 25))
MANY, MANY_LEN = 2100, 300      # the 11-bit field's world
FIELD = 2048                    # first contig id the packed row cannot hold
SHARED_STATS = ("reads", "fallback_reads", "tier1_ovf")


def contig_world(seed, lengths, ns=(), repeat=False):
    """(reference index, port index, forward text) of a random genome cut
    into contigs of ``lengths``, with N runs ``ns``; with ``repeat`` a
    250 bp stretch of the first contig is copied into the fifth."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, sum(lengths)).astype(np.uint8)
    if repeat:
        o4 = sum(lengths[:4])
        g[o4 + 1000:o4 + 1250] = g[1500:1750]
    seqs, off = [], 0
    for k, ln in enumerate(lengths):
        s = list(dna.decode(g[off:off + ln]))
        for c, where, n in ns:
            if c == k:
                lo = 0 if where == "start" else ln - n
                s[lo:lo + n] = "N" * n
        seqs.append((f"ctg{k}", "".join(s)))
        off += ln
    jidx = build_index(seqs)
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, idx, idx.get_seq(0, idx.l_pac)


def small_records(fwd, anns):
    recs = fastx.simulate_reads(fwd, 48, read_len=100, error_rate=0.02,
                                indel_rate=0.002, seed=2)
    return (recs + cl.straddlers(fwd, anns) + cl.flush_reads(fwd, anns, 12)
            + cl.chimeras(fwd, anns, 8, seed=5))


def many_records(fwd):
    """Two reads (forward, reverse) inside each of contigs 2030-2099 and
    reads straddling the boundaries from 2040 on, plus 24 simulated
    reads over the whole text."""
    rng = np.random.default_rng(9)
    recs = fastx.simulate_reads(fwd, 24, read_len=100, error_rate=0.01,
                                seed=4)
    for c in range(2030, MANY):
        p = c * MANY_LEN + int(rng.integers(0, MANY_LEN - 100))
        r = fwd[p:p + 100]
        recs += [fastx.FastxRecord(f"in_{c}_f", dna.decode(r)),
                 fastx.FastxRecord(f"in_{c}_r", dna.decode(dna.revcomp(r)))]
    anns = [(f"c{k}", k * MANY_LEN, MANY_LEN) for k in range(MANY)]
    return recs + cl.straddlers(fwd, anns[2040:2061], overs=(50,))


def many_aligners(jidx, idx, lut):
    """Both packages' aligners on the 2100-contig world, with tier 2's row
    quantum at 128 (512 by default) in both, as in test_torch_pipeline_
    tiers.py: the padded big-caps batch stays small, the gates and the
    path are unchanged."""
    aln = Aligner(idx, device="cpu", lut_cache=lut)
    jaln = JAligner(jidx, lut_cache=lut)
    aln.TIER2_ROWS = jaln.TIER2_ROWS = 128
    return aln, jaln


def rnames_at_or_past(sam: str, names, first: int) -> int:
    """Primary records of ``sam`` placed on contig ``first`` or later."""
    late = set(names[first:])
    return sum(1 for line in sam.splitlines()
               if not int(line.split("\t")[1]) & 0x900
               and line.split("\t")[2] in late)


@pytest.fixture(scope="module")
def small():
    return contig_world(21, SMALL_LENGTHS, SMALL_NS, repeat=True)


@pytest.fixture(scope="module")
def many(tmp_path_factory):
    """The 2100-contig world and a k-mer table cache that both packages'
    aligners share (the format is common; one build instead of two)."""
    return contig_world(22, (MANY_LEN,) * MANY) + (
        tmp_path_factory.mktemp("many") / "lut.npz",)


def test_small_world_se_equals_reference_and_oracle(small):
    jidx, idx, fwd = small
    assert len(idx.anns) == 12 and min(a.length for a in idx.anns) < 100
    assert len(idx.ambs) == len(SMALL_NS)
    aln, jaln = Aligner(idx, device="cpu"), JAligner(jidx)
    recs = small_records(fwd, idx.anns)
    batch = fastx.batch_reads(recs)
    assert sorted(set(batch.lens.tolist())) == [100, 250]
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert got == jaln.align_se(batch, id0=0)
    for k in SHARED_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    body = got.splitlines()
    # every contig but the 60 bp one holds a primary record, and the
    # chimeras' supplementary records name another contig in SA:Z
    placed = {l.split("\t")[2] for l in body
              if not int(l.split("\t")[1]) & 0x904}
    assert placed >= {a.name for a in idx.anns if a.length >= 100}
    sa_other = [l for l in body if l.startswith("chim_") and "SA:Z:" in l
                and l.split("SA:Z:")[1].split(",")[0] != l.split("\t")[2]]
    assert len(sa_other) >= 4


def test_many_contigs_past_the_field_fall_to_the_oracle(many):
    jidx, idx, fwd, lut = many
    aln, jaln = many_aligners(jidx, idx, lut)
    batch = fastx.batch_reads(many_records(fwd))
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert got == jaln.align_se(batch, id0=0)
    for k in SHARED_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    st = aln.stats
    names = [a.name for a in idx.anns]
    late = rnames_at_or_past(got, names, FIELD)
    # every read placed past the field overflowed every tier: tier 2 and
    # tier 3 each ran on all of tier 1's overflow, the oracle took them
    assert late >= 100
    assert st["tier_batches"][0]["tier2"]
    assert st["tier2_rows"] == st["tier3_rows"] == st["tier1_ovf"]
    assert st["fallback_reads"] >= late
    assert rnames_at_or_past(got, names, 2030) > late


@pytest.mark.parametrize("name", cl.NAMES)
@pytest.mark.parametrize("l_pac", [4_600_000, 200_000, 30_001])
def test_layout_covers_the_text(name, l_pac):
    lay = cl.layout(l_pac, name)
    assert len(lay) == cl.COUNTS[name] == {"grch38": 195,
                                           "hs38dh": 3366}[name]
    assert [o for _, o, _ in lay] == list(np.cumsum(
        [0] + [n for _, _, n in lay])[:-1])
    assert sum(n for _, _, n in lay) == l_pac
    assert min(n for _, _, n in lay) >= 1
    names = [n for n, _, _ in lay]
    assert names[:3] == ["chr1", "chr2", "chr3"] and len(set(names)) == \
        len(names)
    assert names.index("chr2") < names.index("chr10")
    if name == "hs38dh":
        assert names[195] == "alt_0" and names[-1] == "HLA_524"
        assert sum(n.startswith("decoy_") for n in names) == 2385


def test_layout_too_short_raises():
    with pytest.raises(ValueError, match="empty"):
        cl.layout(3000, "hs38dh")


@pytest.mark.parametrize("name", cl.NAMES)
def test_reannotated_index_equals_split_build(name):
    g = genome.synthetic_genome(60_000, seed=2024, profile=genome.BACTERIAL)
    text = dna.decode(g)
    whole = build_index([("U00096_synth", text)])
    lay = cl.layout(whole.l_pac, name)
    split = build_index([(n, text[o:o + ln]) for n, o, ln in lay])
    got = cl.reannotate(FMIndex.from_arrays(
        vars(whole), [(a.name, a.offset, a.length) for a in whole.anns]),
        name)
    for f in ("l_pac", "primary", "L2", "bwt_words", "occ_cp", "sa_samples",
              "sa_intv", "pac", "ambs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(split, f),
                                      err_msg=f)
    assert [(a.name, a.offset, a.length) for a in got.anns] == \
        [(a.name, a.offset, a.length) for a in split.anns]
