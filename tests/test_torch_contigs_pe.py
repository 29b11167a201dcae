"""tpubwa_torch on references of many contigs, paired-end.

  * tests/test_torch_contigs_se.py's 30 kbp world of 12 contigs (N runs
    at contig ends): simulated pairs, fragments centred on every contig
    boundary, pairs whose mates lie on two contigs (RNEXT not "="), and
    pairs whose second mate, an error every 7 bases, is found only by the
    mate rescue in a window that the contig's end cuts short;
  * the 2100-contig world: pairs inside contigs 2030-2099, whose ends on
    contig 2048 or later overflow every tier and take the oracle's
    regions;
through Aligner(..., device="cpu").align_pe: SAM byte-equal to
tpubwa.pipeline.Aligner and to the oracle's align_pe, with equal stats and
no rescue window missing from the injected results.
"""
import numpy as np

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_contigs_se import (FIELD, MANY, MANY_LEN, SHARED_STATS,
                                   many, many_aligners,  # noqa: F401
                                   rnames_at_or_past, small)  # noqa: F401
from test_torch_pipeline_pe import assert_same_sam
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import contig_layouts as cl

PE_STATS = SHARED_STATS + ("rescue_tasks",)


def small_pairs(fwd, anns):
    recs = fastx.simulate_reads(fwd, 48, read_len=100, paired=True,
                                error_rate=0.01, seed=1, insert_mean=320,
                                insert_std=25)
    return (recs + cl.boundary_pairs(fwd, anns, 1, 320, 100)
            + cl.split_pairs(fwd, anns, 8, seed=6, read_len=100)
            + cl.end_rescue_pairs(fwd, anns, 6, seed=7, insert=320,
                                  read_len=100))


def many_pairs(fwd):
    """A pair inside each of contigs 2030-2099 (fragments of 240-280
    bases) and 24 simulated pairs over the whole text."""
    rng = np.random.default_rng(12)
    recs = fastx.simulate_reads(fwd, 24, read_len=100, paired=True,
                                error_rate=0.01, seed=8, insert_mean=260,
                                insert_std=10)
    for c in range(2030, MANY):
        ins = int(rng.integers(240, 281))
        p = c * MANY_LEN + int(rng.integers(0, MANY_LEN - ins + 1))
        frag = fwd[p:p + ins]
        recs += [fastx.FastxRecord(f"in_{c}", dna.decode(frag[:100])),
                 fastx.FastxRecord(f"in_{c}",
                                   dna.decode(dna.revcomp(frag[-100:])))]
    return recs


def run_both(aln, jaln, batch):
    """align_pe in both packages; the port's SAM held to the oracle's and
    the reference's, stats compared, no rescue result missing. Returns
    the port's SAM."""
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    got = aln.align_pe(batch, id0=0)
    assert lib.tb_rescue_miss_count() == 0
    assert got.count("\n") >= batch.n
    assert_same_sam(got, aln.oracle.align_pe(batch, aln.opt, id0=0)[0],
                    "the oracle")
    assert_same_sam(got, jaln.align_pe(batch, id0=0), "tpubwa.Aligner")
    for k in PE_STATS:
        assert aln.stats.get(k, 0) == jaln.stats.get(k, 0), k
    return got


def clamped(tasks, anns, l_pac):
    """Rescue tasks (pair, end, j, dir, is_rev, rb, re, rid) whose window,
    in forward coordinates, starts or ends at its contig's start or end."""
    n = 0
    for rb, re, rid in tasks[:, 5:8]:
        if re > l_pac:
            rb, re = 2 * l_pac - re, 2 * l_pac - rb
        a = anns[int(rid)]
        n += rb == a.offset or re == a.offset + a.length
    return n


def test_small_world_pe_equals_reference_and_oracle(small):
    jidx, idx, fwd = small
    aln, jaln = Aligner(idx, device="cpu"), JAligner(jidx)
    tasks = []
    pe_tasks = aln._pe_tasks

    def record(ctx):
        t = pe_tasks(ctx)
        tasks.append(t)
        return t
    aln._pe_tasks = record
    batch = fastx.batch_reads(small_pairs(fwd, idx.anns))
    got = run_both(aln, jaln, batch)
    tasks = np.concatenate(tasks)
    assert aln.stats["rescue_tasks"] == len(tasks) > 0
    assert clamped(tasks, idx.anns, idx.l_pac) >= 2
    body = got.splitlines()
    # mates on two contigs: RNEXT names the other contig
    assert sum(l.split("\t")[6] not in ("=", "*") for l in body) >= 8
    # the heavy-error mates near contig ends are placed, beside their
    # first mates
    resc = [l.split("\t") for l in body if l.startswith("endresc_")]
    placed = [f for f in resc if not int(f[1]) & 0x904]
    assert len(placed) == len(resc) == 12
    assert all(f[6] == "=" for f in placed)


def test_many_contigs_pe_past_the_field(many):
    jidx, idx, fwd, lut = many
    aln, jaln = many_aligners(jidx, idx, lut)
    batch = fastx.batch_reads(many_pairs(fwd))
    got = run_both(aln, jaln, batch)
    st = aln.stats
    late = rnames_at_or_past(got, [a.name for a in idx.anns], FIELD)
    assert late >= 100
    assert st["tier2_rows"] == st["tier3_rows"] == st["tier1_ovf"]
    assert st["fallback_reads"] >= late
