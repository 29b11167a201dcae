"""tpubwa_torch's genome-scale overflow diagnostics on the CPU at a tiny
size (0.3 Mbp with the HUMAN profile forced, prepared by
tools/scale_bench.py into a temporary directory): tools/diag_scale.py,
tools/diag_tier2.py and tools/classify_overflow.py, the counterparts of
scripts/diag_scale.py, scripts/diag_tier2.py and
scripts/classify_overflow.py, held count for count to the reference
package's computation on the same reads (its stage functions, Aligner
and Oracle, on an index built by the reference from the same genome).
Also the two faults of scripts/classify_overflow.py that the port does
not copy, and the split of seeding overflow into cap-driven and
dense-budget-driven reads."""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index as j_build_index
from tpubwa.oracle import Oracle as JOracle
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.pipeline import Aligner as JAligner
from tpubwa_torch.pipeline import _slice_batch
from tpubwa_torch.tools import classify_overflow as co
from tpubwa_torch.tools import diag_caps, diag_scale, diag_tier2
from tpubwa_torch.tools import scale_bench as sb
from test_torch_diag import ref_stage_flags
from test_torch_diag_tier2 import ref_diag_tier2

MBP = 0.3
READS = 64      # classify_overflow's reads and the split's
SMALL = 16      # diag_scale's and diag_tier2's: the first 16 of them


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The prepared 0.3 Mbp world, the port's aligner on the CPU, the
    reference's aligner (sharing the port's k-mer table cache) and a batch
    of the tools' reads."""
    d = tmp_path_factory.mktemp("diag")
    sb.prepare(MBP, {}, "human", d)
    g, idx = sb.load_cached(MBP, {}, "human", d)
    aln = sb.make_aligner(idx, MBP, {}, "cpu", "human", d)
    jidx = j_build_index([("scale_synth", np.asarray(g))])
    jaln = JAligner(jidx, JMemOptions(),
                    lut_cache=sb.lut_path(MBP, "human", d))
    return d, aln, jaln, sb.se_batch(g, READS)


def test_diag_scale_equals_reference(world):
    d, aln, jaln, batch = world
    got = diag_scale.run(MBP, SMALL, "cpu", "human", d)
    part = _slice_batch(batch, 0, SMALL)
    f = ref_stage_flags(jaln, part.seqs, part.lens)
    buf = np.asarray(jaln.worker1_packed(part.seqs, part.lens))
    packed = jaln._unpack_host(buf, SMALL)[1]
    o = {s: int(f[s].sum()) for s in diag_caps.STAGES}
    assert got["overflow"] == {**o, "packed": int(packed.sum())}
    assert got["added"] == {s: int((f[s] & ~f[p]).sum()) for p, s in
                            zip(diag_caps.STAGES, diag_caps.STAGES[1:])}
    assert got["smems_mean"] == float(f["n_smems"].mean())
    assert got["smems_max"] == int(f["n_smems"].max())
    assert got["regs_mean"] == float(f["n_regs"].mean())
    assert got["stage_not_packed"] == int((f["extend"] & ~packed).sum()) == 0
    assert got["batch"] == SMALL and o["seeding"] > 0
    assert set(got["costs"]) == {"genome_load_s", "index_load_s",
                                 "aligner_init_s"}


def test_diag_tier2_on_the_genome_equals_reference(world, monkeypatch):
    """The tools' first 16 reads: both tiers' gates stay closed, so every
    tier-1 overflow read is left and broken down, padded to 16 rows (the
    row quantum lowered from 512 to keep the test small). The breakdown's
    counts are held to the reference on the repeat world of
    tests/test_torch_diag_tier2.py, where the reference compiles the big
    configurations in a fifth of the time it takes on this index."""
    _, aln, jaln, batch = world
    monkeypatch.setattr(aln, "TIER2_ROWS", 16, raising=False)
    part = _slice_batch(batch, 0, SMALL)
    got = diag_tier2.diag_tier2(aln, part)
    want, _ = ref_diag_tier2(jaln, part, breakdown=False)
    assert {k: got[k] for k in want} == want
    assert not want["tier2_fired"]
    assert want["after_tiers"] == want["tier1_overflow"] > 0
    assert got["tier2_config"]["rows"] == want["after_tiers"]


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_classify_overflow_equals_reference(world, fast):
    """The reference script's keys, from the reference's Oracle with the
    occurrence count taken from column 2 of its SMEM rows and the chains
    counted by chain id."""
    d, _, jaln, batch = world
    got = co.run(READS, MBP, fast, "human", d)
    orc, opt = JOracle(jaln.idx), JMemOptions()
    counts = []
    for i in range(batch.n):
        seq = batch.seqs[i][:batch.lens[i]]
        sm = orc.smems(seq, opt)
        n_chain = n_reg = 0
        if not fast:
            n_chain = len(set(orc.chains(seq, opt, filtered=False)[:, 3]))
            n_reg = len(orc.regs_pre(seq, opt)[0])
        counts.append((len(sm), int(np.minimum(sm[:, 2], opt.max_occ).sum()),
                       n_chain, n_reg))
    c = np.array(counts)
    caps = np.array([[32, 128, 32, 32], [63, 640, 64, 63]])
    over = [(c > cap).any(axis=1) for cap in caps]
    want = {"n_reads": READS, "genome_mbp": MBP, "fast": fast,
            "tier1_overflow": int(over[0].sum()),
            "tier2_overflow": int(over[1].sum()),
            **{f"t2_cap_{k}": int((over[1] & (c[:, j] > caps[1, j])).sum())
               for j, k in enumerate(co.CAPS)},
            "seed_count_p50": int(np.percentile(c[:, 1], 50)),
            "seed_count_p90": int(np.percentile(c[:, 1], 90)),
            "seed_count_p99": int(np.percentile(c[:, 1], 99)),
            "seed_count_max": int(c[:, 1].max()),
            "t2_need_seeds_cap_for_99pct": int(np.percentile(c[:, 1], 99))}
    assert got == {k: v for k, v in want.items() if v or not k.startswith(
        ("t2_cap_", "tier"))}
    if not fast:
        assert want["tier1_overflow"] > 0


def test_classify_reference_script_faults(world):
    """scripts/classify_overflow.py reads the occurrence count from column
    3 of the oracle's SMEM rows (k, l, s, qbeg, qend), the query begin, and
    counts the seed rows of the oracle's chains as chains: both give
    other numbers than the counts the caps apply to."""
    _, aln, jaln, batch = world
    orc, opt = JOracle(jaln.idx), JMemOptions()
    counts = co.oracle_counts(aln.oracle, batch, aln.opt, fast=False)
    script_seeds, script_chains = [], []
    for i in range(batch.n):
        seq = batch.seqs[i][:batch.lens[i]]
        sm = orc.smems(seq, opt)
        script_seeds.append(int(np.minimum(sm[:, 3], opt.max_occ).sum())
                            if len(sm) else 0)
        script_chains.append(len(orc.chains(seq, opt, filtered=False)))
    assert (np.array(script_seeds) != counts[:, 1]).sum() > READS // 2
    assert (np.array(script_chains) > counts[:, 2]).any()
    assert (np.array(script_chains) >= counts[:, 2]).all()


def test_split_counts_cap_and_dense_budget_reads(world):
    """On this world most reads flagged at seeding have every oracle count
    inside the tier-1 caps: the batch-wide dense budgets flagged them."""
    _, aln, _, batch = world
    seeded = diag_caps.stage_flags(aln, batch.seqs, batch.lens)["seeding"]
    counts = co.oracle_counts(aln.oracle, batch, aln.opt)
    s = co.split(seeded, counts, co.T1)
    capped = co.over(counts, co.T1)
    assert s == {"reads": READS, "after_seeding": int(seeded.sum()),
                 "over_a_cap": int(capped.sum()),
                 "seeding_and_cap": int((seeded & capped).sum()),
                 "dense_budgets": int((seeded & ~capped).sum())}
    assert s["after_seeding"] == s["seeding_and_cap"] + s["dense_budgets"]
    assert s["dense_budgets"] > s["seeding_and_cap"]


def test_a_missing_world_names_the_prepare_command(tmp_path):
    for run in (lambda: diag_scale.run(MBP, 16, "cpu", "human", tmp_path),
                lambda: diag_tier2.run(MBP, 16, "cpu", "human", tmp_path),
                lambda: co.run(16, MBP, True, "human", tmp_path)):
        with pytest.raises(FileNotFoundError,
                           match=r"scale_bench 4096 0.3 --prepare"):
            run()


@pytest.mark.parametrize("tool", [diag_scale, diag_tier2])
def test_the_card_is_required_without_platform_cpu(tool):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["0.3", "16"])
