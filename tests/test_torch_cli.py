"""tpubwa_torch's command line against tpubwa's, in-process.

index / align / sort / merge through both packages' main() on a 9 kbp
two-sequence world: whole SAM files byte-equal on the SE, interleaved PE
and two-file PE paths (with -R and --id0), the same .npz index array for
array, --shard-dir resume, the SAM utilities, the FASTA/FASTQ readers and
the phase timer. One test runs ``python -m tpubwa_torch`` as a subprocess.
"""
import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
import tpubwa.cli as jcli
from tpubwa.io import fastx as jfastx
from tpubwa.io import sam as jsam
from tpubwa.utils import dna
from tpubwa_torch import cli
from tpubwa_torch.io import fastx, sam
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.utils.profiling import PhaseTimer, device_trace

REPO = Path(__file__).resolve().parents[1]
# SE: two batches of 12 reads; PE: one batch of 12 pairs (a batch of fewer
# than 10 pairs has no insert-size estimate, so no proper pairs)
BATCH = {"se": "12", "se_oracle": "12", "pe_interleaved": "24",
         "pe_two_files": "24"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(55)
    g = rng.integers(0, 4, 9000).astype(np.uint8)
    ga, gb = dna.decode(g[:5000]), dna.decode(g[5000:])
    # a multi-line record, a header with a description, blank lines
    fa = ">cA\n" + "\n".join(ga[i:i + 60] for i in range(0, 5000, 60)) + \
        "\n\n>cB second sequence\n" + gb + "\n"
    (d / "g.fa").write_text(fa)
    assert cli.main(["index", str(d / "g.fa"), "-o", str(d / "g.npz")]) == 0
    fastx.write_fastq(d / "se.fq", fastx.simulate_reads(
        g, 24, read_len=100, error_rate=0.02, seed=2))
    pe = fastx.simulate_reads(g, 12, read_len=100, paired=True, seed=3,
                              error_rate=0.01, insert_mean=300,
                              insert_std=30)
    fastx.write_fastq(d / "r_1.fq", pe[0::2])
    fastx.write_fastq(d / "r_2.fq", pe[1::2])
    fastx.write_fastq(d / "ri.fq", pe)
    return d, g


def align_args(d, mode, out):
    npz = str(d / "g.npz")
    files = {"se": ["se.fq"], "se_oracle": ["se.fq"], "pe_interleaved":
             ["ri.fq"], "pe_two_files": ["r_1.fq", "r_2.fq"]}[mode]
    args = ["align", npz, *[str(d / f) for f in files], "-o", str(out),
            "--platform", "cpu", "--batch-size", BATCH[mode], "-R", "rg1",
            "--id0", "6"]
    if mode == "pe_interleaved":
        args.append("-p")
    if mode == "se_oracle":
        args.append("--oracle")
    return args


@pytest.mark.parametrize("mode", ["se", "se_oracle", "pe_interleaved",
                                  "pe_two_files"])
def test_align_file_equals_reference_cli(world, mode):
    d, _ = world
    got, want = d / f"{mode}.port.sam", d / f"{mode}.ref.sam"
    assert cli.main(align_args(d, mode, got)) == 0
    assert jcli.main(align_args(d, mode, want)) == 0
    text = got.read_text()
    assert text == want.read_text()
    assert text.startswith("@SQ\tSN:cA\tLN:5000\n@SQ\tSN:cB\tLN:4000\n"
                           "@RG\tID:rg1\n@PG\tID:tpubwa")
    body = [l for l in text.splitlines() if not l.startswith("@")]
    assert len(body) >= 24 and all("RG:Z:rg1" in l for l in body)
    if mode.startswith("pe"):
        assert any(int(l.split("\t")[1]) & 0x2 for l in body)


def test_two_files_pe_equals_interleaved(world):
    d, _ = world
    a, b = d / "two.sam", d / "inter.sam"
    assert cli.main(align_args(d, "pe_two_files", a)) == 0
    assert cli.main(align_args(d, "pe_interleaved", b)) == 0
    assert a.read_text() == b.read_text()


def test_two_file_length_mismatch(world, tmp_path):
    d, _ = world
    recs = list(fastx.iter_fastq(d / "r_2.fq"))
    fastx.write_fastq(tmp_path / "short_2.fq", recs[:-1])
    with pytest.raises(SystemExit, match="mate files differ in length"):
        cli.main(["align", str(d / "g.npz"), str(d / "r_1.fq"),
                  str(tmp_path / "short_2.fq"), "-o",
                  str(tmp_path / "x.sam"), "--platform", "cpu"])


def test_platform_cuda_without_a_card_fails(world, tmp_path, monkeypatch):
    d, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["align", str(d / "g.npz"), str(d / "se.fq"), "-o",
                  str(tmp_path / "x.sam")])


def test_shard_dir_resume_and_merge(world, tmp_path, capsys):
    d, _ = world
    sd = tmp_path / "shards"
    cmd = ["align", str(d / "g.npz"), str(d / "se.fq"), "--platform",
           "cpu", "--batch-size", "10", "--shard-dir", str(sd)]
    assert cli.main(cmd) == 0
    assert "batch 2: 4 reads" in capsys.readouterr().err
    shards = sorted(sd.glob("shard_*.sam"))
    assert len(shards) == 3                         # 10 + 10 + 4
    before = [s.read_text() for s in shards]
    # the rerun finds every batch in the manifest and aligns none
    assert cli.main(cmd) == 0
    err = capsys.readouterr().err
    assert "batch" not in err and "total 0 records" in err
    assert [s.read_text() for s in shards] == before
    whole = tmp_path / "whole.sam"
    assert cli.main(["align", str(d / "g.npz"), str(d / "se.fq"), "-o",
                     str(whole), "--platform", "cpu"]) == 0
    merged = tmp_path / "merged.sam"
    assert cli.main(["merge", str(sd / "header.sam"), *map(str, shards),
                     "-o", str(merged)]) == 0
    assert merged.read_text() == whole.read_text()
    # a pre-marked batch is skipped and the others keep global read ids
    sd2 = tmp_path / "shards2"
    sd2.mkdir()
    sam.Manifest(sd2 / "manifest.jsonl").mark(0, 10, "pre")
    assert cli.main(cmd[:-1] + [str(sd2)]) == 0
    assert not (sd2 / "shard_000000.sam").exists()
    recs = list(fastx.iter_fastq(d / "se.fq"))
    from tpubwa_torch.index.builder import FMIndex
    from tpubwa_torch.oracle import Oracle
    want = Oracle(FMIndex.load(d / "g.npz")).align_se(
        fastx.batch_reads(recs[10:20]), MemOptions(), id0=10)
    assert (sd2 / "shard_000001.sam").read_text() == want


def test_merge_and_sort_equal_reference(world, tmp_path):
    d, g = world
    from tpubwa_torch.index.builder import FMIndex
    from tpubwa_torch.oracle import Oracle
    orc = Oracle(FMIndex.load(d / "g.npz"))
    recs = fastx.simulate_reads(g, 30, read_len=100, seed=1)
    hdr = "@HD\tVN:1.0\n@SQ\tSN:cA\tLN:5000\n@SQ\tSN:cB\tLN:4000\n"
    parts = [hdr + orc.align_se(fastx.batch_reads(recs[a:b]), MemOptions(),
                                id0=a) for a, b in ((0, 13), (13, 30))]
    paths = [tmp_path / "a.sam", tmp_path / "b.sam"]
    for p, t in zip(paths, parts):
        p.write_text(t)
    for srt in (False, True):
        got, want = tmp_path / f"m{srt}.sam", tmp_path / f"w{srt}.sam"
        assert sam.merge_shards(paths, got, sort=srt) == 30
        assert jsam.merge_shards(paths, want, sort=srt) == 30
        assert got.read_text() == want.read_text()
        via_cli = tmp_path / f"c{srt}.sam"
        assert cli.main(["merge", *map(str, paths), "-o", str(via_cli)]
                        + (["--sort"] if srt else [])) == 0
        assert via_cli.read_text() == want.read_text()
    merged = (tmp_path / "mFalse.sam").read_text()
    assert merged == hdr + orc.align_se(fastx.batch_reads(recs),
                                        MemOptions(), id0=0)
    srt = sam.coordinate_sort(merged)
    assert srt == jsam.coordinate_sort(merged)
    assert srt.startswith("@HD\tVN:1.6\tSO:coordinate\n@SQ")
    keys = [(l.split("\t")[2], int(l.split("\t")[3]))
            for l in srt.splitlines() if not l.startswith("@")]
    rank = {"cA": 0, "cB": 1, "*": 2}
    assert keys == sorted(keys, key=lambda k: (rank[k[0]], k[1]
                                               if k[0] != "*" else 0))
    assert sam.split_header(merged) == jsam.split_header(merged)
    assert cli.main(["sort", str(tmp_path / "mFalse.sam"), "-o",
                     str(tmp_path / "s.sam")]) == 0
    assert (tmp_path / "s.sam").read_text() == srt


def test_manifest_reload(tmp_path):
    m = sam.Manifest(tmp_path / "man.jsonl")
    assert not m.is_done(0)
    m.mark(0, 512, "shard0")
    m.mark(2, 100, "shard2")
    m2 = sam.Manifest(tmp_path / "man.jsonl")
    assert m2.is_done(0) and m2.is_done(2) and not m2.is_done(1)
    assert m2.done[2] == {"batch": 2, "n_reads": 100, "path": "shard2"}
    assert m2.done == jsam.Manifest(tmp_path / "man.jsonl").done


def test_index_equals_reference_cli(world, tmp_path):
    d, _ = world
    want = tmp_path / "ref.npz"
    assert jcli.main(["index", str(d / "g.fa"), "-o", str(want)]) == 0
    a, b = np.load(d / "g.npz"), np.load(want)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got8 = tmp_path / "p8.npz"
    want8 = tmp_path / "r8.npz"
    assert cli.main(["index", str(d / "g.fa"), "-o", str(got8),
                     "--sa-intv", "8"]) == 0
    assert jcli.main(["index", str(d / "g.fa"), "-o", str(want8),
                      "--sa-intv", "8"]) == 0
    a, b = np.load(got8), np.load(want8)
    assert int(a["sa_intv"]) == 8
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_fastx_readers_equal_reference(world, tmp_path, gz):
    d, _ = world
    fa_text = (d / "g.fa").read_text()
    recs = fastx.simulate_reads(np.arange(400, dtype=np.uint8) % 4, 5,
                                read_len=30, seed=1)
    recs[1].qual = "#" * 30
    fastx.write_fastq(tmp_path / "w.fq", recs)
    # the first header carries a comment after the name
    fq_text = (tmp_path / "w.fq").read_text().replace(
        "\n", " extra words\n", 1)
    fa, fq = tmp_path / "x.fa", tmp_path / "x.fq"
    if gz:
        fa, fq = fa.with_suffix(".fa.gz"), fq.with_suffix(".fq.gz")
        with gzip.open(fa, "wt") as f:
            f.write(fa_text)
        with gzip.open(fq, "wt") as f:
            f.write(fq_text)
    else:
        fa.write_text(fa_text)
        fq.write_text(fq_text)
    seqs = fastx.read_fasta(fa)
    assert seqs == jfastx.read_fasta(fa)
    assert [n for n, _ in seqs] == ["cA", "cB"]
    assert [len(s) for _, s in seqs] == [5000, 4000]
    got = [(r.name, r.seq, r.qual, r.comment) for r in fastx.iter_fastq(fq)]
    want = [(r.name, r.seq, r.qual, r.comment)
            for r in jfastx.iter_fastq(fq)]
    assert got == want and got[0][3] == "extra words"
    assert got[1][2] == "#" * 30 and got[0][2] == "I" * 30
    assert [(n, s) for n, s, _, _ in got] == [(r.name, r.seq) for r in recs]


def test_phase_timer(tmp_path):
    t = PhaseTimer()
    x = {"a": [torch.zeros(3), (torch.ones(2),)]}
    with t.phase("a"):
        assert t.sync(x) is x
    with t.phase("a"):
        pass
    with t.phase("b"):
        t.sync(torch.arange(4))
    rep = t.report()
    assert t.counts == {"a": 2, "b": 1}
    assert rep.splitlines()[0].split() == ["phase", "total_s", "calls",
                                           "share"]
    assert {l.split()[0] for l in rep.splitlines()[1:]} == {"a", "b"}
    with device_trace(tmp_path / "trace"):
        torch.arange(100).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_module_entry_point(world, tmp_path):
    """python -m tpubwa_torch runs the command line."""
    d, _ = world
    out = tmp_path / "sub.sam"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    r = subprocess.run([sys.executable, "-m", "tpubwa_torch", *align_args(
        d, "se", out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "total 24 records" in r.stderr
    inproc = tmp_path / "in.sam"
    assert cli.main(align_args(d, "se", inproc)) == 0
    assert out.read_text() == inproc.read_text()
