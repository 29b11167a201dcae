"""tpubwa_torch big-caps tiers: repeat-dense reads that overflow tier 1
stay on the device path (tier-2, task-parallel engine; tier-3, round
engine) with SAM byte-equal to the oracle, and at tier 2 to
tpubwa.Aligner too (tests/test_tier2.py-style worlds; the tier-2 world
has 200 copies so that its repeat read does overflow tier 1, and the
one-read gates are lowered to force each path). The reference package's
own tests hold its tier-3 SAM to the oracle, so the port is compared with
the oracle there."""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner


def repeat_world(seed, unit_len, copies, gap, flank, n_mut):
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, flank).astype(np.uint8)]
    for _ in range(copies):
        c = unit.copy()
        p = rng.integers(0, unit_len, n_mut)
        c[p] = (c[p] + 1) % 4
        parts.append(c)
        parts.append(rng.integers(0, 4, gap).astype(np.uint8))
    parts.append(rng.integers(0, 4, flank).astype(np.uint8))
    g = np.concatenate(parts)
    jidx = build_index([("rep", dna.decode(g))])
    tidx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, tidx, g, unit


def tier_batch(g, unit, seed, span):
    rng = np.random.default_rng(seed)
    recs = [fastx.FastxRecord(f"u_{i}", dna.decode(g[p:p + 100]))
            for i, p in enumerate(rng.integers(0, span, 6))]
    recs.append(fastx.FastxRecord("rep_read", dna.decode(unit[:100])))
    return fastx.batch_reads(recs, max_len=100)


# the one-read gates that force each path; smaller row quanta keep the
# padded big-caps batches (and the tests) small while leaving the
# batch-wide dense budgets room for the one repeat read
GATES = {2: dict(TIER2_MIN=1, TIER2_ROWS=64),
         3: dict(TIER3_MIN=1, TIER3_ROWS=8)}


@pytest.fixture(scope="module")
def tier2_world():
    """200 copies: each SMEM -> 200 seeds, beyond tier 1's 128-seed cap but
    inside tier 2's 640. One reference aligner for the module's tests, so
    its compiled worker1 is reused."""
    jidx, tidx, g, unit = repeat_world(55, 200, 200, 40, 3000, 2)
    jaln = JAligner(jidx)
    vars(jaln).update(GATES[2])
    return tidx, g, unit, jaln


@pytest.mark.parametrize("tier", [2, 3])
def test_repeat_read_stays_on_device(tier, request):
    if tier == 2:
        tidx, g, unit, jaln = request.getfixturevalue("tier2_world")
        batch = tier_batch(g, unit, 6, 2900)
    else:
        # ~800 copies: beyond tier 2's 640 seeds, inside tier 3's 1280
        _, tidx, g, unit = repeat_world(56, 120, 800, 10, 2000, 1)
        batch = tier_batch(g, unit, 7, 1900)
    aln = Aligner(tidx, device="cpu")
    vars(aln).update(GATES[tier])
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    if tier == 2:
        assert got == jaln.align_se(batch, id0=0)
    assert aln.stats["tier1_ovf"] == 1
    assert aln.stats["fallback_reads"] == 0


def test_tier2_merges_before_the_finish(tier2_world):
    """Tier 2 is merged before any read of the batch is finished, the
    clean reads' runs (before and after the repeat read) included; the SAM
    is byte-equal to the reference and the oracle."""
    tidx, g, unit, jaln = tier2_world
    b = tier_batch(g, unit, 6, 2900)
    order = [0, 6, 1, 2, 3, 4, 5]
    recs = [fastx.FastxRecord(b.names[i], dna.decode(b.seqs[i][:b.lens[i]]))
            for i in order]
    batch = fastx.batch_reads(recs, max_len=100)
    aln = Aligner(tidx, device="cpu")
    vars(aln).update(GATES[2])
    events = []

    def logged(what, fn):
        def call(*a):
            events.append(what)
            return fn(*a)
        return call
    aln._tier2_merge = logged("merge", aln._tier2_merge)
    aln._finish_threaded = logged("finish", aln._finish_threaded)
    aln._finish_chunk = logged("chunk", aln._finish_chunk)
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert got == jaln.align_se(batch, id0=0)
    # clean runs on both sides of the repeat read (the batch-wide dense
    # budgets also push the last two reads to tier 2, one run of two)
    _, ovf, _, _ = aln._unpack_host(aln.worker1_packed(
        batch.seqs, batch.lens).numpy(), batch.n)
    assert list(ovf) == [False, True, False, False, False, True, True]
    assert aln.stats["tier1_ovf"] == aln.stats["tier2_rows"] == ovf.sum()
    assert aln.stats["tier_batches"] == [
        {"first_read": batch.names[0], "tier1_ovf": 3, "tier2": True}]
    assert aln.stats["fallback_reads"] == 0
    assert events[:2] == ["merge", "finish"], events
    assert set(events[2:]) == {"chunk"}, events
