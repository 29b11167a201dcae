"""tpubwa_torch extension engine == tpubwa's extend_chains, on the CPU.

The same seeds and chains (from each package's own LUT seeding) go
through both packages' extend_chains with the task-parallel engine and
with the round engine (the big-caps tier's), on the
tests/test_device_worker.py world; the region dicts must be equal, and
the overflow-free reads must match the oracle's pre-dedup regions.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.chain import device as jchain
from tpubwa.extend import worker as jworker
from tpubwa.index.builder import build_index
from tpubwa.index.device import DeviceIndex as JDeviceIndex
from tpubwa.io import fastx
from tpubwa.opts import MemOptions
from tpubwa.oracle import Oracle
from tpubwa.pipeline import configs_from_opts
from tpubwa.seed import lut as jlut
from tpubwa.utils import dna
from tpubwa_torch.chain import device as tchain
from tpubwa_torch.extend import worker as tworker
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.index.device import DeviceIndex as TDeviceIndex
from tpubwa_torch.seed import lut as tlut

OPT = MemOptions()
FIELDS = ("rb", "re", "qb", "qe", "score", "truesc", "w", "seedcov",
          "seedlen0", "cid", "rid", "n", "overflow", "ptr", "skipped")


def port_cfg(cls, cfg, **kw):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg) if f.name in names}, **kw)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(321)
    g = rng.integers(0, 4, 16000).astype(np.uint8)
    g[7000:7300] = g[2000:2300]
    genome = dna.decode(g)
    jidx = build_index([("chrA", genome[:10000]), ("chrB", genome[10000:])])
    tidx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    fwd = dna.encode(genome)
    recs = fastx.simulate_reads(fwd[:10000], 20, read_len=100,
                                error_rate=0.04, seed=2)
    recs += [fastx.FastxRecord(f"rep{p}", dna.decode(fwd[p:p + 100]))
             for p in (7000, 7100, 7190, 2050)]
    rng = np.random.default_rng(5)
    for i in range(8):
        p = int(rng.integers(0, 9000))
        r = fwd[p:p + 110].copy()
        q = int(rng.integers(10, 90))
        dl = int(rng.integers(1, 6))
        r = (np.concatenate([r[:q], r[q + dl:]]) if i % 2 else
             np.concatenate([r[:q], rng.integers(0, 4, dl).astype(np.uint8),
                             r[q:]]))
        recs.append(fastx.FastxRecord(f"ind{i}", dna.decode(r[:100])))
    for i in range(4):
        p1, p2 = int(rng.integers(0, 9000)), int(rng.integers(0, 9000))
        cut = int(rng.integers(30, 70))
        recs.append(fastx.FastxRecord(f"chi{i}", dna.decode(np.concatenate(
            [fwd[p1:p1 + cut], fwd[p2:p2 + 100 - cut]]))))
    recs += [fastx.FastxRecord(f"rc{p}",
                               dna.decode(dna.revcomp(fwd[p:p + 100])))
             for p in (500, 4000, 12000)]
    batch = fastx.batch_reads(recs)
    return jidx, tidx, batch


def run_both(world, task_parallel):
    jidx, tidx, batch = world
    scfg, ccfg, ecfg = configs_from_opts(OPT, text_len=2 * jidx.l_pac)
    ecfg = dataclasses.replace(ecfg, task_parallel=task_parallel)
    jd = JDeviceIndex.from_host(jidx)
    td = TDeviceIndex.from_host(tidx, "cpu")
    seqs = batch.seqs.astype(np.int32)
    # jax side
    jl = jlut.KmerLUT.build(jidx)
    js = jlut.collect_smems_lut(jd, jl, jnp.asarray(seqs),
                                jnp.asarray(batch.lens), scfg)
    jsd = jchain.seeds_from_smems(jd, js, ccfg)
    jch = jchain.chain_seeds(jd, jsd, ccfg)
    jst = jworker.extend_chains(jd, jnp.asarray(seqs),
                                jnp.asarray(batch.lens), jsd, jch, ecfg,
                                jchain.chain_filter(jch, ccfg))
    # port
    tl = tlut.KmerLUT.build(tidx, device="cpu")
    tccfg = port_cfg(tchain.ChainConfig, ccfg)
    ts = tlut.collect_smems_lut(td, tl, torch.tensor(seqs),
                                torch.tensor(batch.lens),
                                port_cfg(tlut.LutSeedConfig, scfg))
    tsd = tchain.seeds_from_smems(td, ts, tccfg)
    tch = tchain.chain_seeds(td, tsd, tccfg)
    tst = tworker.extend_chains(td, torch.tensor(seqs),
                                torch.tensor(batch.lens), tsd, tch,
                                port_cfg(tworker.ExtendConfig, ecfg),
                                tchain.chain_filter(tch, tccfg))
    return jst, tst


@pytest.mark.parametrize("task_parallel", [True, False],
                         ids=["taskpar", "rounds"])
def test_regions_equal(world, task_parallel):
    jst, tst = run_both(world, task_parallel)
    for f in FIELDS:
        j = np.asarray(jst[f])
        t = tst[f].numpy()
        assert j.dtype == t.dtype, (f, j.dtype, t.dtype)
        np.testing.assert_array_equal(j, t, err_msg=f)
    # and the regions are the oracle's (pre-dedup, push order)
    jidx, tidx, batch = world
    orc = Oracle(jidx)
    n, ovf = tst["n"].numpy(), tst["overflow"].numpy()
    checked = 0
    for b in range(batch.n):
        if ovf[b]:
            continue
        host = orc.regs(batch.seqs[b][:batch.lens[b]], OPT, stage=0)
        want = [(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[10])
                for r in host.tolist()]
        got = [tuple(int(tst[f][b, i]) for f in
                     ("rb", "re", "qb", "qe", "seedcov", "score", "truesc",
                      "seedlen0", "w")) for i in range(n[b])]
        assert got == want, f"read {b}"
        checked += 1
    assert checked >= batch.n * 3 // 4


def test_cal_max_gap_matches():
    from tpubwa.extend.worker import cal_max_gap as jgap
    cfg = tworker.ExtendConfig()
    jcfg = jworker.ExtendConfig()
    q = np.arange(-20, 400, dtype=np.int32)
    np.testing.assert_array_equal(
        np.asarray(jgap(jcfg, jnp.asarray(q))),
        tworker.cal_max_gap(cfg, torch.tensor(q)).numpy())
    assert all(tworker.cal_max_gap(cfg, int(x)) == jgap(jcfg, int(x))
               for x in (-5, 0, 1, 19, 100, 151, 250))
