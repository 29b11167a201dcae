"""tpubwa_torch's parity spot check (tools/parity.py) and kill-and-resume
rehearsal (tools/run_1m.py) on the CPU at a tiny size. parity passes on
a clean batch and fails when one line of the oracle's SAM is altered (it
holds the port to the oracle alone, so its world is a port-only index);
run_1m's resumed run starts past batch 0 and its merged shards equal an
uninterrupted run. Without a card both raise unless --platform cpu is
given."""
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa_torch.index.builder import FMIndex, build_index
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import parity, run_1m
from tpubwa_torch.utils import dna, genome

SE_READS = 32


@pytest.fixture(scope="module")
def aln():
    """The port's aligner on the 120 kbp genome of the bench world's
    (bacterial) profile that test_torch_profile_se.py aligns."""
    g = genome.synthetic_genome(120_000, seed=5, profile=genome.BACTERIAL)
    return Aligner(build_index([("bench_synth", dna.decode(g))]),
                   device="cpu")


def test_parity_passes_and_fails(aln, capsys):
    r = parity.parity(aln, SE_READS)
    assert r["differ"] == 0 and r["records"] >= SE_READS
    assert parity.report(r) == 0
    assert "PASS" in capsys.readouterr().out
    real = aln.oracle.align_se

    def altered(*a, **kw):
        lines = real(*a, **kw).split("\n")
        f = lines[3].split("\t")
        f[3] = str(int(f[3]) + 1)               # one POS off by one
        lines[3] = "\t".join(f)
        return "\n".join(lines)
    aln.oracle.align_se = altered
    try:
        r = parity.parity(aln, SE_READS)
    finally:
        del aln.oracle.align_se
    assert r["differ"] == 1 and len(r["first"]) == 1
    assert parity.report(r) == 1
    out = capsys.readouterr().out
    assert "DEV:" in out and "ORC:" in out and "FAIL: 1/" in out


def test_run_1m_kill_and_resume(tmp_path):
    """A tiny world prepared as scale_bench prepares it; batches of 4
    pairs; killed once 2 batches are done; the resumed run starts past
    batch 0 and the merged shards equal an uninterrupted run in this
    process."""
    from tpubwa_torch.io import fastx
    from tpubwa_torch.tools import scale_bench as sb
    mbp, pairs, bs = 0.05, 40, 8
    sb.prepare(mbp, {}, build_dir=tmp_path)
    out = run_1m.run_1m(pairs, 0.0, mbp, bs, "cpu", build_dir=tmp_path)
    assert out["phase1_killed"] and out["phase1_rc"] == -9
    assert out["phase2_rc"] == 0
    assert out["phase2_first_batch"] >= 2 and out["resume_skipped_done"]
    assert out["records_ok"] and out["total_records"] == 2 * pairs
    assert out["n_shards"] == pairs * 2 // bs
    idx_path, _, lut = sb.cache_paths(int(mbp * 1e6), "bacterial", tmp_path)
    aln = Aligner(FMIndex.load(idx_path), device="cpu", lut_cache=lut)
    work = tmp_path / "run1m_0.05"
    recs = [r for m in zip(fastx.iter_fastq(work / "r_1.fq"),
                           fastx.iter_fastq(work / "r_2.fq")) for r in m]
    want = aln.sam_header() + "".join(
        aln.align_pe(fastx.batch_reads(recs[i:i + bs]), id0=i // 2)
        for i in range(0, len(recs), bs))
    assert (work / "merged.sam").read_text() == want
    assert (work / "RUN_1M.json").exists()


@pytest.mark.parametrize("tool", [parity, run_1m])
def test_the_card_is_required_without_platform_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
