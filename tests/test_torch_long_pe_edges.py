"""tpubwa_torch on the pairs a 2x300 library is full of, which the
simulator cannot make (tpubwa_torch/tools/long_pairs.py), on
tests/test_torch_long_pe.py's 30 kbp world:

  * one 2x300 batch of overlapping mates, read-through pairs (fragments
    shorter than a read, each read running into the TruSeq adapter),
    pairs trimmed to 36-300 bases an end, and rescue pairs;
  * a broad-insert library (650 +- 250) whose rescue window is over 1792
    bases, so the rescue call's T is at least 2048 in the generic K2
    instance (whose row maxima are in a device-memory workspace);
  * align_pe_stream over batches of 2x250, 2x300 and 2x250 in turn;
through Aligner(..., device="cpu"): SAM byte-equal to
tpubwa.pipeline.Aligner and to the oracle, with equal stats and no rescue
result missing. Also: the builders are deterministic, and their pairs have
the shapes they promise.
"""
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_long_pe import (PAIRS, RESCUED, instances, pe_batch, reset,
                                run_pe, widths, world)  # noqa: F401
from test_torch_pipeline_pe import assert_same_sam
from tpubwa_torch.io import fastx
from tpubwa_torch.ops import sw_local
from tpubwa_torch.tools import long_pairs as lp
from tpubwa_torch.utils import dna

L = 300
EDGE = 6            # overlap, read-through and trimmed pairs, each
SMEM_48K = 48 * 1024

BUILDERS = {
    "overlap": lambda f, s: lp.overlap_pairs(f, 8, L, s),
    "readthrough": lambda f, s: lp.readthrough_pairs(f, 8, L, s),
    "trimmed": lambda f, s: lp.trimmed_pairs(f, 8, L, s, 650, 60),
    "rescue": lambda f, s: lp.rescue_pairs(f, 8, L, s, 650),
    "wide": lambda f, s: lp.wide_pairs(f, 8, L, s, 650, 250),
}


def edge_records(fwd) -> list:
    """(c): as many pairs as a test_torch_long_pe batch, so that the
    reference compiles one shape."""
    return (lp.overlap_pairs(fwd, EDGE, L, 61)
            + lp.readthrough_pairs(fwd, EDGE, L, 62)
            + lp.trimmed_pairs(fwd, EDGE, L, 63, 650, 60)
            + lp.rescue_pairs(fwd, PAIRS + RESCUED - 3 * EDGE, L, 64, 650))


def wide_records(fwd) -> list:
    """(d): broad inserts, and rescue pairs so that a rescue task runs."""
    return (lp.wide_pairs(fwd, PAIRS, L, 65, 650, 250)
            + lp.rescue_pairs(fwd, RESCUED, L, 66, 650))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_are_deterministic(world, name):
    fwd = world[2]
    a, b, c = (BUILDERS[name](fwd, s) for s in (7, 7, 8))
    assert len(a) == 16 and a == b and a != c
    assert all(x.name == y.name for x, y in zip(a[0::2], a[1::2]))
    assert all(set(r.seq) <= set("ACGT") for r in a)


def test_builders_make_the_pairs_they_promise(world):
    fwd = world[2]
    ins = [int(r.name.split("_")[-1]) for r in lp.overlap_pairs(
        fwd, 50, L, 1)[::2]]
    assert L <= min(ins) and max(ins) <= 2 * L
    wide = [int(r.name.split("_")[-1]) for r in lp.wide_pairs(
        fwd, 200, L, 2, 650, 250)[::2]]
    assert min(wide) >= L and max(wide) > 2 * L + 200
    lens = [len(r.seq) for r in lp.trimmed_pairs(fwd, 50, L, 3, 650, 60)]
    assert lp.MIN_LEN <= min(lens) and max(lens) <= L
    assert sum(x != y for x, y in zip(lens[0::2], lens[1::2])) > 40
    for r1, r2 in zip(*[iter(lp.readthrough_pairs(fwd, 30, L, 4))] * 2):
        pos, n = (int(x) for x in r1.name.split("_")[-2:])
        assert L // 2 <= n <= L and len(r1.seq) == len(r2.seq) == L
        frag = dna.decode(fwd[pos:pos + n])
        # the fragment, then the adapter (1% substitutions on both)
        for got, want in ((r1.seq, frag + lp.ADAPTER_R1),
                          (r2.seq, dna.decode(dna.revcomp(fwd[pos:pos + n]))
                           + lp.ADAPTER_R2)):
            k = min(len(want), L)
            assert sum(x != y for x, y in zip(got[:k], want[:k])) <= 0.05 * k
    resc = lp.rescue_pairs(fwd, 4, L, 5, 650)
    for r1, r2 in zip(resc[0::2], resc[1::2]):
        p = int(r1.name.split("_")[-1])
        assert r1.seq == dna.decode(fwd[p:p + L])
        true2 = dna.decode(dna.revcomp(fwd[p + 650 - L:p + 650]))
        assert [q for q in range(L) if r2.seq[q] != true2[q]] == \
            list(range(0, L, 7))


def test_edge_pairs_equal_reference_and_oracle(world, widths):
    aln, jaln, fwd = world
    got = run_pe(aln, jaln, fastx.batch_reads(edge_records(fwd), max_len=L))
    assert aln.stats["rescue_tasks"] > 0
    assert instances(*widths) == ({0}, {True: {0}, False: {0}})
    rec = {}
    for line in got.splitlines():
        f = line.split("\t")
        rec.setdefault(f[0].split("_")[0], []).append(f)
    # overlapping mates pair properly; read-through reads clip the adapter
    assert sum(int(f[1]) & 0x2 for f in rec["ovl"]) >= 2 * EDGE - 2
    assert sum("S" in f[5] for f in rec["rt"]) >= EDGE
    assert all(int(f[1]) & 0x2 for f in rec["resc"])


def test_wide_inserts_open_the_generic_rescue_above_48k(world, widths):
    """A window T of 2048 or more in the generic instance. Its row maxima
    once took T ints a task of shared memory, above 48 KB a block here;
    they are in a device-memory workspace now, so the block's shared
    memory is the query rows' alone and the workspace holds T ints a
    task."""
    aln, jaln, fwd = world
    run_pe(aln, jaln, fastx.batch_reads(wide_records(fwd), max_len=L))
    assert aln.stats["rescue_tasks"] > 0
    _, k2 = widths
    assert instances(*widths)[1] == {True: {0}, False: {0}}
    fwd_calls = [(q, t) for q, t, s in k2 if s]
    assert fwd_calls and min(t for _, t in fwd_calls) >= 2048
    assert all(sw_local.smem_bytes(q) == sw_local.smem_bytes(L) < SMEM_48K
               and sw_local.workspace_bytes(1, t, True) == 4 * t
               for q, t in fwd_calls)


def test_mixed_width_stream_equals_align_pe(world, widths):
    """2x250, 2x300, 2x250 in one stream: each batch byte-equal to
    align_pe and to the oracle, the whole stream to the reference's; K1
    and K2 took the K=8 register instances and the generic ones."""
    aln, jaln, fwd = world
    batches = [pe_batch(fwd, 250), fastx.batch_reads(edge_records(fwd),
                                                     max_len=L),
               fastx.batch_reads(fastx.simulate_reads(
                   fwd, PAIRS + RESCUED, read_len=250, paired=True,
                   error_rate=0.01, seed=67, insert_mean=550,
                   insert_std=50))]
    reset(aln, jaln)
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    got = list(aln.align_pe_stream(batches, id0=9))
    assert lib.tb_rescue_miss_count() == 0
    assert len(got) == len(batches)
    assert "".join(got) == "".join(jaln.align_pe_stream(batches, id0=9))
    k1, k2 = instances(*widths)
    assert k1 == {0, 8} and k2 == {True: {0, 8}, False: {0, 8}}
    n = 9
    for b, sam in zip(batches, got):
        assert_same_sam(sam, aln.align_pe(b, id0=n), "align_pe")
        assert_same_sam(sam, aln.oracle.align_pe(b, aln.opt, id0=n)[0],
                        "the oracle")
        n += b.n // 2
