"""tpubwa_torch windows, LUT seeding and chaining == tpubwa's, on the CPU.

The same reads go through both packages' collect_smems_lut (overflow flags
included), seeds_from_smems, chain_seeds and chain_filter, on the
tests/test_lut_seed.py and tests/test_device_chain.py worlds, in the int32
world and an int64-widened one. Every comparison is exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.chain import device as jchain
from tpubwa.index.builder import build_index
from tpubwa.index.device import DeviceIndex as JDeviceIndex
from tpubwa.io import fastx
from tpubwa.ops import window as jwin
from tpubwa.opts import MemOptions
from tpubwa.seed import lut as jlut
from tpubwa.utils import dna
from tpubwa_torch.chain import device as tchain
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.index.device import DeviceIndex as TDeviceIndex
from tpubwa_torch.ops import window as twin
from tpubwa_torch.seed import lut as tlut

OPT = MemOptions()


def port_index(jidx) -> FMIndex:
    return FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])


def port_cfg(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def make_world(g, names_at):
    genome = dna.decode(g)
    cuts = [0, *names_at, len(genome)]
    jidx = build_index([(f"chr{i}", genome[a:b])
                        for i, (a, b) in enumerate(zip(cuts, cuts[1:]))])
    tidx = port_index(jidx)
    jd = JDeviceIndex.from_host(jidx)
    td = TDeviceIndex.from_host(tidx, "cpu")
    jl = jlut.KmerLUT.build(jidx, min_seed_len=OPT.min_seed_len)
    tl = tlut.KmerLUT.build(tidx, min_seed_len=OPT.min_seed_len,
                            device="cpu")
    return dict(jd=jd, td=td, jl=jl, tl=tl, fwd=dna.encode(genome),
                l_pac=jidx.l_pac)


@pytest.fixture(scope="module")
def lut_world():
    rng = np.random.default_rng(77)
    g = rng.integers(0, 4, 12000).astype(np.uint8)
    g[6000:6200] = g[1000:1200]  # 200bp duplicate (round-2 trigger)
    g[9000:9060] = g[2000:2060]  # 60bp duplicate
    return make_world(g, [])


@pytest.fixture(scope="module")
def chain_world():
    rng = np.random.default_rng(123)
    g = rng.integers(0, 4, 15000).astype(np.uint8)
    g[7000:7300] = g[2000:2300]   # 300bp duplicate: multi-chain reads
    g[11000:11080] = g[2100:2180]
    return make_world(g, [9000])


def widen(w):
    jd, td = w["jd"], w["td"]
    return dict(w, jd=dataclasses.replace(
        jd, L2=jd.L2.astype(jnp.int64),
        sa_samples=jd.sa_samples.astype(jnp.int64),
        ann_end=jd.ann_end.astype(jnp.int64)),
        td=dataclasses.replace(
            td, L2=td.L2.to(torch.int64),
            sa_samples=td.sa_samples.to(torch.int64),
            ann_end=td.ann_end.to(torch.int64)),
        jl=jlut.KmerLUT(w["jl"].k0, w["jl"].ksp.astype(jnp.int64)),
        tl=tlut.KmerLUT(w["tl"].k0, w["tl"].ksp.to(torch.int64)))


def assert_dicts_equal(jd, td, what):
    assert set(jd) == set(td), what
    for k in jd:
        j = np.asarray(jd[k])
        t = td[k].numpy()
        assert j.dtype == t.dtype, (what, k, j.dtype, t.dtype)
        np.testing.assert_array_equal(j, t, err_msg=f"{what}.{k}")


def lut_reads(fwd, seed, B=40, L=100):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(fwd) - L, B)
    reads = np.stack([fwd[s:s + L] for s in starts]).astype(np.int32)
    reads[:8] = np.stack([fwd[1000 + 7 * i: 1000 + 7 * i + L]
                          for i in range(8)])        # inside the duplicate
    mut = rng.random(reads.shape) < 0.03
    reads = np.where(mut, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.int32)
    reads[30, 40] = 4                                 # N mid-read
    reads[31, :6] = 4                                 # N head
    for b in range(34, 40):                           # reverse strand
        reads[b] = dna.revcomp(reads[b].astype(np.uint8))
    lens = np.full(B, L, np.int32)
    lens[32], lens[33] = 10, 30                       # short reads
    reads[32, 10:] = 4
    reads[33, 30:] = 4
    return reads, lens


@pytest.mark.parametrize("W", [96, 200, 290])
def test_text_windows(lut_world, W):
    w = lut_world
    n = 2 * w["l_pac"]
    rng = np.random.default_rng(W)
    pos = np.concatenate([rng.integers(-5, n + 5, 120),
                          [0, w["l_pac"] - 1, w["l_pac"], n - 1, n]])
    for jf, tf in ((jwin.text_window_asc, twin.text_window_asc),
                   (jwin.text_window_desc, twin.text_window_desc)):
        np.testing.assert_array_equal(
            np.asarray(jf(w["jd"], jnp.asarray(pos, jnp.int32), W)),
            tf(w["td"], torch.tensor(pos, dtype=torch.int32), W).numpy())


@pytest.mark.parametrize("L,W", [(64, 64), (100, 100), (128, 290)])
def test_query_windows_and_slices(L, W):
    rng = np.random.default_rng(L + W)
    seqs = rng.integers(0, 5, (24, L)).astype(np.int32)
    st = rng.integers(-3, L + 4, 24).astype(np.int32)
    for jf, tf in ((jwin.query_window_asc, twin.query_window_asc),
                   (jwin.query_window_desc, twin.query_window_desc)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(seqs), jnp.asarray(st), W)),
            tf(torch.tensor(seqs), torch.tensor(st), W).numpy())
    flat = rng.integers(0, 100, 7 * L + 3).astype(np.int32)
    starts = rng.integers(-2, 7 * L + 6, 30).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jwin.slice_rows(jnp.asarray(flat), jnp.asarray(starts),
                                   W)),
        twin.slice_rows(torch.tensor(flat), torch.tensor(starts), W).numpy())


def test_lut_table_matches(lut_world):
    w = lut_world
    assert w["jl"].k0 == w["tl"].k0
    np.testing.assert_array_equal(np.asarray(w["jl"].ksp),
                                  w["tl"].ksp.numpy())


@pytest.mark.parametrize("width", ["int32", "int64"])
@pytest.mark.parametrize("budget", ["default", "tight"])
def test_smems_equal(lut_world, width, budget):
    w = widen(lut_world) if width == "int64" else lut_world
    kw = dict(min_seed_len=OPT.min_seed_len, split_len=OPT.split_len,
              split_width=OPT.split_width)
    # tight budgets overflow reads on purpose: the flags must agree too
    kw.update({"default": {}, "tight": dict(fm_dense=512, offdiag_dense=512,
                                            r2_rows=16, max_reseed=2,
                                            max_smems=6)}[budget])
    jcfg = jlut.LutSeedConfig(**kw)
    tcfg = tlut.LutSeedConfig(**kw)
    reads, lens = lut_reads(w["fwd"], seed=5)
    js = jlut.collect_smems_lut(w["jd"], w["jl"], jnp.asarray(reads),
                                jnp.asarray(lens), jcfg)
    ts = tlut.collect_smems_lut(w["td"], w["tl"], torch.tensor(reads),
                                torch.tensor(lens), tcfg)
    assert_dicts_equal(js, ts, f"smems[{width},{budget}]")
    if budget == "tight":
        assert np.asarray(js["overflow"]).any()


def _chain_pipeline(w, reads, lens, width_tag):
    from tpubwa.pipeline import configs_from_opts
    scfg, ccfg, _ = configs_from_opts(OPT, text_len=2 * w["l_pac"])
    js = jlut.collect_smems_lut(w["jd"], w["jl"], jnp.asarray(reads),
                                jnp.asarray(lens), scfg)
    ts = tlut.collect_smems_lut(w["td"], w["tl"], torch.tensor(reads),
                                torch.tensor(lens),
                                port_cfg(tlut.LutSeedConfig, scfg))
    tccfg = port_cfg(tchain.ChainConfig, ccfg)
    jsd = jchain.seeds_from_smems(w["jd"], js, ccfg)
    tsd = tchain.seeds_from_smems(w["td"], ts, tccfg)
    assert_dicts_equal(jsd, tsd, f"seeds[{width_tag}]")
    jch = jchain.chain_seeds(w["jd"], jsd, ccfg)
    tch = tchain.chain_seeds(w["td"], tsd, tccfg)
    assert_dicts_equal(jch, tch, f"chains[{width_tag}]")
    assert_dicts_equal(jchain.chain_filter(jch, ccfg),
                       tchain.chain_filter(tch, tccfg), f"flt[{width_tag}]")
    return tch


@pytest.mark.parametrize("width", ["int32", "int64"])
def test_chains_equal(chain_world, width):
    w = widen(chain_world) if width == "int64" else chain_world
    fwd = w["fwd"]
    rng = np.random.default_rng(3)
    recs = fastx.simulate_reads(fwd, 24, read_len=100, error_rate=0.03,
                                seed=3)
    recs += [fastx.FastxRecord(f"r{p}", dna.decode(fwd[p:p + 100]))
             for p in (7000, 7100, 2050, 10990, 8950)]   # repeats, boundary
    for i in range(5):                                    # chimeras
        p1, p2 = rng.integers(0, 14000, 2)
        cut = int(rng.integers(30, 70))
        recs.append(fastx.FastxRecord(f"chi{i}", dna.decode(np.concatenate(
            [fwd[p1:p1 + cut], fwd[p2:p2 + 100 - cut]]))))
    batch = fastx.batch_reads(recs)
    tch = _chain_pipeline(w, batch.seqs.astype(np.int32), batch.lens, width)
    assert int(tch["n"].max()) >= 2          # multi-chain reads exercised


def test_chains_with_budget_overflow(chain_world):
    """A batch of repeat reads overflows the dense SA-walk budget (the
    batch shape of test_chains_equal, so the reference's compiled
    functions are reused)."""
    w = chain_world
    fwd = w["fwd"]
    reads = np.stack([fwd[7000 + 3 * i: 7100 + 3 * i]
                      for i in range(34)]).astype(np.int32)
    lens = np.full(34, 100, np.int32)
    tch = _chain_pipeline(w, reads, lens, "repeats")
    assert bool(tch["overflow"].any())
