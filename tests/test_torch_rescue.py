"""tpubwa_torch mate rescue and its satellites against the reference.

``ksw_align_batch`` (forward pass + start extraction) against the
reference's and the scalar oracle; ``run_rescue_tasks`` against the
reference's on real task rows from the native task generator;
``pe_hist_psum`` and the paired read simulator against theirs. Tolerance 0
everywhere: integers and strings.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.dist.mesh import make_mesh
from tpubwa.dist.mesh import pe_hist_psum as j_pe_hist_psum
from tpubwa.index.builder import build_index
from tpubwa.io import fastx as jfastx
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.pair import rescue as jrescue
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch import oracle
from tpubwa_torch.dist.mesh import pe_hist_psum
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.pair import rescue
from tpubwa_torch.pipeline import Aligner

from test_torch_local import cases

OPT = MemOptions()
KEYS = ("score", "tb", "te", "qb", "qe", "score2", "te2")


def port_align(qs, qlen, ts, tlen, minsc, valid):
    t = [torch.tensor(np.asarray(a, np.int32))
         for a in (qs, qlen, ts, tlen, minsc, valid)]
    return rescue.ksw_align_batch(*t).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2, "edge"])
def test_ksw_align_batch_matches_reference(seed):
    qs, qlen, ts, tlen, minsc, valid = cases(seed)
    got = port_align(qs, qlen, ts, tlen, minsc, valid)
    assert got.shape == (len(qlen), 7) and got.dtype == np.int32
    want = np.asarray(jrescue.ksw_align_batch(
        jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
        jnp.asarray(tlen), jnp.asarray(minsc), jnp.asarray(valid != 0)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ksw_align_batch_matches_scalar_oracle(seed):
    qs, qlen, ts, tlen, minsc, _ = cases(seed)
    got = port_align(qs, qlen, ts, tlen, minsc, np.ones_like(qlen))
    want = np.array([
        [oracle.ksw_align_local(qs[i, :qlen[i]], ts[i, :tlen[i]], OPT,
                                int(minsc[i]))[k] for k in KEYS]
        for i in range(len(qlen))])
    np.testing.assert_array_equal(got, want)


def test_rev_prefix_matches_reference():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 5, (9, 37)).astype(np.int32)
    end = rng.integers(0, 37, 9).astype(np.int32)
    end[:2] = (0, 36)
    got = rescue._rev_prefix(torch.tensor(rows), torch.tensor(end)).numpy()
    want = np.asarray(jrescue._rev_prefix(jnp.asarray(rows),
                                          jnp.asarray(end)))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(999)
    g = rng.integers(0, 4, 25000).astype(np.uint8)
    g[12000:12200] = g[4000:4200]
    genome = dna.decode(g)
    jidx = build_index([("chr1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, Aligner(idx, device="cpu"), dna.encode(genome)


def rescue_batch(fwd):
    """FR pairs, heavy-error mates (seeding fails on one end, so rescue
    has work) and enough same-strand pairs that the FF orientation gets
    insert statistics too: its windows take the mate as it is, the FR
    windows reverse-complement it."""
    rng = np.random.default_rng(11)
    recs = fastx.simulate_reads(fwd, 40, read_len=100, paired=True,
                                error_rate=0.01, seed=5, insert_mean=320,
                                insert_std=25)
    for k, p in enumerate((3000, 9000, 15000)):
        frag = fwd[p:p + 300]
        r2 = dna.revcomp(frag[-100:]).copy()
        for q in range(0, 100, 7):
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        recs.append(fastx.FastxRecord(f"resc{k}", dna.decode(frag[:100])))
        recs.append(fastx.FastxRecord(f"resc{k}", dna.decode(r2)))
    for k in range(14):
        frag = fwd[1000 + 1500 * k:1000 + 1500 * k + 300 + k]
        recs.append(fastx.FastxRecord(f"ff{k}", dna.decode(frag[:100])))
        recs.append(fastx.FastxRecord(f"ff{k}", dna.decode(frag[-100:])))
    return fastx.batch_reads(recs)


def test_run_rescue_tasks_matches_reference(world):
    jidx, aln, fwd = world
    batch = rescue_batch(fwd)
    id0 = 7
    buf = aln.worker1_packed(batch.seqs, batch.lens).numpy()
    ctx = aln._pe_stage_a(batch, buf, id0)
    tasks = ctx["tasks"]
    assert len(tasks) > 0
    assert set(np.unique(tasks[:, 4])) == {0, 1}   # forward and is_rev
    got = rescue.run_rescue_tasks(aln.didx, batch.seqs, batch.lens, tasks,
                                  id0, OPT)
    assert got.shape == (len(tasks), 7) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ctx["res_dev"].numpy())
    want = jrescue.run_rescue_tasks(JAligner(jidx).didx, batch.seqs,
                                    batch.lens, tasks, id0, JMemOptions(),
                                    False)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] >= OPT.min_seed_len).any()      # some window scored
    assert rescue.run_rescue_tasks(aln.didx, batch.seqs, batch.lens,
                                   tasks[:0], id0, OPT).shape == (0, 7)


@pytest.mark.parametrize("max_ins", [500, 10000])
def test_pe_hist_psum_matches_reference(max_ins):
    rng = np.random.default_rng(max_ins)
    dirs = rng.integers(-1, 4, 301).astype(np.int32)
    dirs[:3] = -1
    isz = rng.integers(0, max_ins + 400, 301).astype(np.int64)
    isz[5] = max_ins
    isz[6] = max_ins + 1
    got = pe_hist_psum(dirs, isz, max_ins, "cpu")
    assert got.shape == (4, max_ins + 1) and got.dtype == np.int64
    assert got.sum() == int((dirs >= 0).sum())
    want = j_pe_hist_psum(make_mesh(1, local=True), dirs, isz, max_ins)
    np.testing.assert_array_equal(got, want)
    assert pe_hist_psum(dirs[:0], isz[:0], max_ins, "cpu").sum() == 0


@pytest.mark.parametrize("kw", [
    dict(paired=True, seed=1, error_rate=0.01, insert_mean=320,
         insert_std=25),
    dict(paired=True, seed=2, error_rate=0.02, indel_rate=0.01,
         read_len=150, insert_mean=400, insert_std=50),
    dict(paired=True, seed=3),
    dict(paired=False, seed=4, error_rate=0.02, indel_rate=0.005),
])
def test_simulate_reads_paired_matches_reference(world, kw):
    fwd = world[2]
    got = fastx.simulate_reads(fwd, 30, **kw)
    want = jfastx.simulate_reads(fwd, 30, **kw)
    assert len(got) == (60 if kw["paired"] else 30)
    assert [(r.name, r.seq, r.qual) for r in got] == \
        [(r.name, r.seq, r.qual) for r in want]
