"""tpubwa_torch's command line on a reference of many contigs.

A 60 kbp text cut into the grch38 layout's 195 records
(tpubwa_torch/tools/contig_layouts.py), with N runs at the start of every
10th contig and the end of every 15th, written as a multi-line FASTA:
``index`` gives arrays equal to tpubwa.cli's, annotations included;
``align`` SE and two-file PE, ``align --shard-dir`` + ``merge --sort`` and
``sort`` write files byte-equal to tpubwa.cli's, with 195 @SQ lines in
the layout's order, and the sorted files place chr2 before chr10.
"""
import numpy as np
import pytest

import tpubwa.cli as jcli
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa_torch import cli
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.tools import contig_layouts as cl
from tpubwa_torch.utils import dna

L_PAC = 60_000
ARRAYS = ("l_pac", "primary", "L2", "bwt_words", "occ_cp", "sa_samples",
          "sa_intv", "pac", "ann_names", "ann_offsets", "ann_lengths",
          "ambs")


def reads_at(fwd, lay, names, per: int = 2):
    """``per`` 100 bp reads from the middle of each contig in ``names``."""
    recs = []
    for name, off, ln in lay:
        if name in names:
            for k in range(per):
                p = off + ln // 2 - 100 + 60 * k
                recs.append(fastx.FastxRecord(
                    f"mid_{name}_{k}", dna.decode(fwd[p:p + 100])))
    return recs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("contigs_cli")
    g = np.random.default_rng(77).integers(0, 4, L_PAC).astype(np.uint8)
    lay = cl.layout(L_PAC, "grch38")
    (d / "g.fa").write_text(cl.fasta_text(cl.gapped_records(g, lay, 3)))
    assert cli.main(["index", str(d / "g.fa"), "-o", str(d / "g.npz")]) == 0
    assert jcli.main(["index", str(d / "g.fa"), "-o",
                      str(d / "ref.npz")]) == 0
    fwd = FMIndex.load(d / "g.npz").get_seq(0, L_PAC)
    # 32 SE reads (two batches of 16): simulated, from the middles of
    # chr2, chr10 and chrX, and across every 40th boundary both ways
    se = fastx.simulate_reads(fwd, 16, read_len=100, error_rate=0.02,
                              seed=2)
    se += reads_at(fwd, lay, ("chr10", "chr2", "chrX")) + \
        cl.straddlers(fwd, lay, every=40, overs=(50,))
    assert len(se) == 32
    fastx.write_fastq(d / "se.fq", se)
    # 16 pairs (one batch), 4 of them on two contigs
    pe = fastx.simulate_reads(fwd, 12, read_len=100, paired=True, seed=3,
                              error_rate=0.01, insert_mean=300,
                              insert_std=30)
    pe += cl.split_pairs(fwd, lay, 4, seed=4, read_len=100)
    fastx.write_fastq(d / "r_1.fq", pe[0::2])
    fastx.write_fastq(d / "r_2.fq", pe[1::2])
    return d, lay


def both(d, args, name):
    """Run ``args`` (with "{out}" for the output) through both command
    lines; returns the port's file's text after asserting it equals the
    reference's byte for byte."""
    got, want = d / f"{name}.port.sam", d / f"{name}.ref.sam"
    assert cli.main([a.replace("{out}", str(got)) for a in args]) == 0
    assert jcli.main([a.replace("{out}", str(want)) for a in args]) == 0
    text = got.read_text()
    assert text == want.read_text(), name
    return text


def test_index_equals_reference_cli(world):
    d, lay = world
    got, want = np.load(d / "g.npz"), np.load(d / "ref.npz")
    for f in ARRAYS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert list(got["ann_names"]) == [n for n, _, _ in lay]
    assert list(got["ann_lengths"]) == [n for _, _, n in lay]
    # an N run at the start of every 10th contig and one at the end of
    # every 15th
    assert len(got["ambs"]) == len(lay[::10]) + len(lay[::15])


def header_order(text: str) -> list:
    return [l.split("\t")[1][3:] for l in text.splitlines()
            if l.startswith("@SQ")]


@pytest.fixture(scope="module")
def se_whole(world):
    """The SE file of both command lines (equal), in batches of 16
    reads."""
    d, _ = world
    return both(d, align_args(d, "se"), "se")


def align_args(d, mode):
    files = ["se.fq"] if mode == "se" else ["r_1.fq", "r_2.fq"]
    return ["align", str(d / "g.npz"), *[str(d / f) for f in files], "-o",
            "{out}", "--platform", "cpu", "--batch-size",
            "16" if mode == "se" else "32"]


@pytest.mark.parametrize("mode", ["se", "pe_two_files"])
def test_align_equals_reference_cli(world, se_whole, mode):
    d, lay = world
    text = se_whole if mode == "se" else both(d, align_args(d, mode), mode)
    assert header_order(text) == [n for n, _, _ in lay]
    body = [l.split("\t") for l in text.splitlines() if l[0] != "@"]
    assert len(body) >= 32
    if mode == "pe_two_files":
        assert any(f[6] not in ("=", "*") for f in body)


def test_shards_merge_sort_and_sort_equal_reference_cli(world, se_whole):
    d, lay = world
    shards = {}
    for pkg, main in (("port", cli.main), ("ref", jcli.main)):
        sd = d / f"shards_{pkg}"
        args = align_args(d, "se")
        assert main(args[:args.index("-o")] + args[args.index("-o") + 2:]
                    + ["--shard-dir", str(sd)]) == 0
        shards[pkg] = [sd / "header.sam"] + sorted(sd.glob("shard_*.sam"))
    assert [p.name for p in shards["port"]] == \
        [p.name for p in shards["ref"]]
    assert len(shards["port"]) == 3                 # 16 + 16 + header
    for a, b in zip(shards["port"], shards["ref"]):
        assert a.read_text() == b.read_text(), a.name
    for pkg, main in (("port", cli.main), ("ref", jcli.main)):
        assert main(["merge", *map(str, shards[pkg]), "-o",
                     str(d / f"merged.{pkg}.sam"), "--sort"]) == 0
    merged = (d / "merged.port.sam").read_text()
    assert merged == (d / "merged.ref.sam").read_text()
    srt = both(d, ["sort", str(d / "se.port.sam"), "-o", "{out}"],
               "sorted")
    assert srt == merged
    assert sorted(srt.splitlines()) == sorted(
        ["@HD\tVN:1.6\tSO:coordinate"] + [l for l in se_whole.splitlines()
                                          if not l.startswith("@HD")])
    rnames = [l.split("\t")[2] for l in srt.splitlines() if l[0] != "@"]
    for a, b in (("chr2", "chr10"), ("chr10", "chrX")):
        assert a in rnames and b in rnames
        assert max(i for i, r in enumerate(rnames) if r == a) < \
            min(i for i, r in enumerate(rnames) if r == b)
    order = {n: k for k, (n, _, _) in enumerate(lay)}
    ranks = [order[r] for r in rnames if r != "*"]
    assert ranks == sorted(ranks)
