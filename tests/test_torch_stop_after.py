"""The debugging cuts of tpubwa_torch's seeding walk and extension engines
(``_stop_after``, what tools/time_stages.py and tools/time_extend.py
bisect with), each held to the reference's same cut, run jitted on JAX's
CPU: array for array and dtype for dtype, tolerance 0. The world is the
200-copy repeat world of tests/test_torch_pipeline_tiers.py: its batch of
7 reads and 3 reads across the edge of the unique flank into the first
repeat copy, which give the task-parallel engine candidates past the
first seed. Also: ``_stop_after=""`` is the call without the argument."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.chain import device as jchain
from tpubwa.extend import worker as jworker
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.seed import lut as jlut
from tpubwa_torch.chain import device as tchain
from tpubwa_torch.extend import worker as tworker
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.seed import lut as tlut
from tpubwa_torch.utils import dna
from test_torch_pipeline_tiers import repeat_world, tier_batch


@pytest.fixture(scope="module")
def world():
    jidx, tidx, g, unit = repeat_world(55, 200, 200, 40, 3000, 2)
    b = tier_batch(g, unit, 6, 2900)
    recs = [fastx.FastxRecord(b.names[i], dna.decode(b.seqs[i][:b.lens[i]]))
            for i in range(b.n)]
    recs += [fastx.FastxRecord(f"edge_{p}", dna.decode(g[p:p + 100]))
             for p in (2950, 2970, 3060)]
    batch = fastx.batch_reads(recs, max_len=100)
    return Aligner(tidx, device="cpu"), JAligner(jidx), batch


def assert_same(got, want, what):
    """Equal values and dtypes, leaf for leaf (a dict's keys too)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def walk_both(world, cut):
    aln, jaln, batch = world
    seqs = batch.seqs.astype(np.int32)
    lens = batch.lens.astype(np.int32)
    ones = np.ones(batch.n, np.int32)
    kw = {} if cut is None else {"_stop_after": cut}
    got = tlut._walk_lut(aln.didx, aln.lut, torch.as_tensor(seqs),
                         torch.as_tensor(lens), torch.as_tensor(ones), True,
                         aln.scfg, **kw)
    want = jax.jit(lambda d, lu, s, le, v: jlut._walk_lut(
        d, lu, s, le, v, True, jaln.scfg, _stop_after=cut or ""))(
        jaln.didx, jaln.lut, jnp.asarray(seqs), jnp.asarray(lens),
        jnp.asarray(ones))
    return got, want


@pytest.mark.parametrize("cut", ["lut", "fm1", "fm2", "diag", ""])
def test_walk_lut_cut_equals_reference(world, cut):
    got, want = walk_both(world, cut)
    # the step count: a Python int in the port, an int32 scalar there
    assert int(got[5]) == int(want[5])
    if cut:
        assert got[5] == 0 and not got[4].any()
    assert_same(got[:5], tuple(want[:5]), f"_walk_lut cut {cut!r}")
    if not cut:
        # the cut's default is the call without it
        plain, _ = walk_both(world, None)
        assert_same(got[:5], tuple(t.numpy() for t in plain[:5]),
                    "_stop_after='' against no argument")
        assert got[5] == plain[5]


def chains_both(world, tier3: bool):
    """Seeds, chains and filter of the batch on each side, and the
    extension configuration: tier 1's (task-parallel) or tier 3's (the
    round engine)."""
    aln, jaln, batch = world
    seqs = batch.seqs.astype(np.int32)
    lens = batch.lens.astype(np.int32)
    ts, tl = torch.as_tensor(seqs), torch.as_tensor(lens)
    sm = tlut.collect_smems_lut(aln.didx, aln.lut, ts, tl, aln.scfg)
    sd = tchain.seeds_from_smems(aln.didx, sm, aln.ccfg)
    ch = tchain.chain_seeds(aln.didx, sd, aln.ccfg)
    port = (ts, tl, sd, ch, tchain.chain_filter(ch, aln.ccfg))

    def ref(d, lu, s, le):
        sm = jlut.collect_smems_lut(d, lu, s, le, jaln.scfg)
        sd = jchain.seeds_from_smems(d, sm, jaln.ccfg)
        ch = jchain.chain_seeds(d, sd, jaln.ccfg)
        return sd, ch, jchain.chain_filter(ch, jaln.ccfg)
    js, jl = jnp.asarray(seqs), jnp.asarray(lens)
    refs = (js, jl, *jax.jit(ref)(jaln.didx, jaln.lut, js, jl))
    ecfg = aln._tier_configs(3)[2] if tier3 else aln.ecfg
    jecfg = dataclasses.replace(jaln.ecfg, **dataclasses.asdict(ecfg))
    assert ecfg.task_parallel == (not tier3)
    return port, refs, ecfg, jecfg


@pytest.fixture(scope="module")
def inputs(world):
    return {t: chains_both(world, t) for t in (False, True)}


@pytest.mark.parametrize("cut,tier3", [
    ("pre", False), ("tp1", False), ("tp2", False), ("tp3", False),
    ("", False), ("sel1", True), ("round1", True), ("sel2", True)])
def test_extend_chains_cut_equals_reference(world, inputs, cut, tier3):
    aln, jaln, _ = world
    (ts, tl, sd, ch, fl), (js, jl, jsd, jch, jfl), ecfg, jecfg = \
        inputs[tier3]
    got = tworker.extend_chains(aln.didx, ts, tl, sd, ch, ecfg, fl,
                                _stop_after=cut)
    want = jworker.extend_chains(jaln.didx, js, jl, jsd, jch, jecfg, jfl,
                                 _stop_after=cut)
    assert_same(got, dict(want), f"extend_chains cut {cut!r}")
    if cut == "tp2":
        # the candidate count a read, what time_extend.py reports
        assert int(got["n"].sum()) > 0
    if not cut:
        assert_same(got, {k: v.numpy() for k, v in tworker.extend_chains(
            aln.didx, ts, tl, sd, ch, ecfg, fl).items()},
            "_stop_after='' against no argument")
