"""tpubwa_torch's differential seeding paths and host FM queries, array for
array against tpubwa and against the scalar oracle.

collect_smems_anchor (bwa's anchor state machine) and collect_smems (the
per-end walk) on the worlds of tests/test_anchor_seed.py and
tests/test_device_seed.py: every output array equal to the reference
package's, n, overflow and the anchor's step count included, and every
read that did not overflow equal to Oracle.smems. Then the host-side FM
queries (index/fmquery.py), the scalar oracle entry points, and the
whole SE pipeline on the anchor path.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa import oracle as joracle
from tpubwa.index import fmquery as jfm
from tpubwa.index.builder import build_index
from tpubwa.index.device import DeviceIndex as JDeviceIndex
from tpubwa.index.device import sel4 as jsel4
from tpubwa.index.device import sel_vec as jsel_vec
from tpubwa.io import fastx as jfastx
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.seed.anchor import AnchorSeedConfig as JAnchorSeedConfig
from tpubwa.seed.anchor import collect_smems_anchor as jcollect_anchor
from tpubwa.seed.device import SeedConfig as JSeedConfig
from tpubwa.seed.device import collect_smems as jcollect_smems
from tpubwa.utils import dna
from tpubwa_torch import oracle
from tpubwa_torch.index import fmquery
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.index.device import DeviceIndex, sel4, sel_vec
from tpubwa_torch.io import fastx
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.pipeline import Aligner, _pack
from tpubwa_torch.seed.anchor import AnchorSeedConfig, collect_smems_anchor
from tpubwa_torch.seed.device import SeedConfig, collect_smems

OPT = MemOptions()
JOPT = JMemOptions()


def port_index(jidx) -> FMIndex:
    return FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])


@pytest.fixture(scope="module")
def world():
    """The 12 kbp genome of both reference test files, planted repeats
    included."""
    rng = np.random.default_rng(77)
    g = rng.integers(0, 4, 12000).astype(np.uint8)
    g[6000:6200] = g[1000:1200]
    g[9000:9060] = g[2000:2060]
    genome = dna.decode(g)
    jidx = build_index([("chr1", genome)])
    idx = port_index(jidx)
    return dict(jidx=jidx, jdidx=JDeviceIndex.from_host(jidx), idx=idx,
                didx=DeviceIndex.from_host(idx, "cpu"),
                orc=oracle.Oracle(idx), fwd=dna.encode(genome))


def _mixed(fwd, n, lo, max_mut, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        ln = int(rng.integers(lo, 150))
        p = int(rng.integers(0, len(fwd) - ln))
        seq = fwd[p:p + ln].copy()
        for _ in range(int(rng.integers(0, max_mut + 1))):
            q = int(rng.integers(0, ln))
            seq[q] = (seq[q] + 1) % 4
        recs.append(fastx.FastxRecord(f"m{i}", dna.decode(seq)))
    return fastx.batch_reads(recs, max_len=160)


def reads(fwd, name: str, anchor: bool):
    """The batches of tests/test_anchor_seed.py (anchor) and
    tests/test_device_seed.py (per-end walk)."""
    if name == "clean":
        return fastx.batch_reads(fastx.simulate_reads(fwd, 24, read_len=100,
                                                      seed=2))
    if name == "noisy":
        return fastx.batch_reads(fastx.simulate_reads(
            fwd, 32, read_len=100, error_rate=0.04 if anchor else 0.03,
            seed=3))
    if name == "repeats":
        return fastx.batch_reads(
            [fastx.FastxRecord(f"r{p}", dna.decode(fwd[p:p + 100]))
             for p in (6000, 6040, 6080, 990, 8990, 9000)])
    if name == "n_short_junk":
        r1 = dna.decode(fwd[100:200])
        recs = [fastx.FastxRecord("n1", r1[:50] + "N" + r1[51:]),
                fastx.FastxRecord("short", dna.decode(fwd[300:310])),
                fastx.FastxRecord("alln", "N" * 30)]
        if anchor:
            recs.append(fastx.FastxRecord(
                "nedge", "N" * 10 + dna.decode(fwd[700:790])))
        return fastx.batch_reads(recs)
    assert name == "mixed"
    return _mixed(fwd, 16, 25, 3, 4) if anchor else _mixed(fwd, 12, 30, 2, 4)


WORLDS = ("clean", "noisy", "repeats", "n_short_junk", "mixed")


def run_both(w, batch, anchor: bool, **cfg_kw):
    """The port's and the reference's outputs on one batch, as numpy."""
    seqs = batch.seqs.astype(np.int32)
    if anchor:
        got = collect_smems_anchor(w["didx"], torch.as_tensor(seqs),
                                   torch.as_tensor(batch.lens),
                                   AnchorSeedConfig(**cfg_kw))
        want = jcollect_anchor(w["jdidx"], jnp.asarray(seqs),
                               jnp.asarray(batch.lens),
                               JAnchorSeedConfig(**cfg_kw))
    else:
        got = collect_smems(w["didx"], torch.as_tensor(seqs),
                            torch.as_tensor(batch.lens), SeedConfig(**cfg_kw))
        want = jcollect_smems(w["jdidx"], jnp.asarray(seqs),
                              jnp.asarray(batch.lens), JSeedConfig(**cfg_kw))
    assert set(got) == set(want)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def assert_equal_outputs(got, want):
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def check_oracle(w, batch, out):
    """Reads that did not overflow: rows (k, s, qb, qe) == Oracle.smems."""
    checked = 0
    for b in range(batch.n):
        if out["overflow"][b]:
            continue
        host = w["orc"].smems(batch.seqs[b][: batch.lens[b]], OPT)
        dev = [(int(out["k"][b, i]), int(out["s"][b, i]),
                int(out["qb"][b, i]), int(out["qe"][b, i]))
               for i in range(out["n"][b])]
        assert dev == [(int(r[0]), int(r[2]), int(r[3]), int(r[4]))
                       for r in host], f"read {b}"
        checked += 1
    return checked


@pytest.mark.parametrize("anchor", [True, False], ids=["anchor", "per_end"])
@pytest.mark.parametrize("name", WORLDS)
def test_seeding_equals_reference_and_oracle(world, name, anchor):
    batch = reads(world["fwd"], name, anchor)
    got, want = run_both(world, batch, anchor)
    assert_equal_outputs(got, want)
    checked = check_oracle(world, batch, got)
    if name in ("clean", "repeats", "n_short_junk"):
        assert checked == batch.n
    else:
        assert checked >= batch.n - 2


# the anchor machine's other modes: direct and dense backward extension,
# several steps between "all done" checks, the FM-only forward pass, and
# caps small enough to overflow: the emissions (max_smems=2), and the
# stack (smax=3, whose reads then run into the hard stop)
ANCHOR_MODES = [dict(row_dense=0), dict(row_dense=0, bwd_dense=2),
                dict(row_dense=0, bwd_dense=1), dict(unroll=3),
                dict(fast_s1=False), dict(smax=3), dict(max_smems=2),
                dict(row_dense=16, unroll=2)]


@pytest.mark.parametrize("mode", ANCHOR_MODES,
                         ids=lambda m: "-".join(f"{k}{v}" for k, v in
                                                m.items()))
def test_anchor_modes_equal_reference(world, mode):
    batch = reads(world["fwd"], "noisy", True)
    got, want = run_both(world, batch, True, **mode)
    assert_equal_outputs(got, want)
    check_oracle(world, batch, got)


@pytest.mark.parametrize("anchor", [True, False], ids=["anchor", "per_end"])
def test_positions_keep_a_64bit_index_width(world, anchor):
    """F3: with int64 ranks and positions (the width of a text above
    2**31) the outputs are the same values, in int64."""
    d = world["didx"]
    wide = dataclasses.replace(
        d, L2=d.L2.to(torch.int64), sa_samples=d.sa_samples.to(torch.int64),
        ann_end=d.ann_end.to(torch.int64))
    batch = reads(world["fwd"], "noisy", anchor)
    seqs, lens = torch.as_tensor(batch.seqs), torch.as_tensor(batch.lens)
    fn, cfg = (collect_smems_anchor, AnchorSeedConfig()) if anchor else \
        (collect_smems, SeedConfig())
    narrow, out = fn(d, seqs, lens, cfg), fn(wide, seqs, lens, cfg)
    assert out["k"].dtype == torch.int64 and out["s"].dtype == torch.int64
    for key in narrow:
        assert torch.equal(out[key].to(torch.int64),
                           narrow[key].to(torch.int64)), key


def test_fmquery_equals_reference(world):
    idx, jidx = world["idx"], world["jidx"]
    rng = np.random.default_rng(9)
    text = 2 * idx.l_pac
    for j in rng.integers(0, text, 64):
        assert fmquery.bwt_base(idx, int(j)) == jfm.bwt_base(jidx, int(j))
    for k in [-1, 0, idx.primary - 1, idx.primary, idx.primary + 1, text,
              *rng.integers(0, text + 1, 64)]:
        np.testing.assert_array_equal(fmquery.occ4(idx, int(k)),
                                      jfm.occ4(jidx, int(k)))
        if 0 < k <= text:
            assert fmquery.bwt_invPsi(idx, int(k)) == \
                jfm.bwt_invPsi(jidx, int(k))
            assert fmquery.bwt_sa(idx, int(k)) == jfm.bwt_sa(jidx, int(k))
    # random intervals: the interval of a random read window, extended
    # both ways by every base
    for _ in range(48):
        p = int(rng.integers(0, idx.l_pac - 12))
        pat = world["fwd"][p:p + int(rng.integers(1, 12))]
        ik, jk = fmquery.init_interval(idx, int(pat[-1])), \
            jfm.init_interval(jidx, int(pat[-1]))
        assert dataclasses.astuple(ik) == dataclasses.astuple(jk)
        for c in pat[-2::-1]:
            ik = fmquery.bwt_extend(idx, ik, True)[int(c)]
            jk = jfm.bwt_extend(jidx, jk, True)[int(c)]
        for is_back in (True, False):
            got = fmquery.bwt_extend(idx, ik, is_back)
            want = jfm.bwt_extend(jidx, jk, is_back)
            assert [dataclasses.astuple(x) for x in got] == \
                [dataclasses.astuple(x) for x in want]


def test_sel4_sel_vec_equal_reference():
    rng = np.random.default_rng(3)
    arr = rng.integers(-2**40, 2**40, (7, 5, 4))
    c = rng.integers(-1, 6, (7, 5))
    got = sel4(torch.as_tensor(arr), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsel4(jnp.asarray(arr), jnp.asarray(c))))
    vec = rng.integers(0, 2**33, 5)
    got = sel_vec(torch.as_tensor(vec), torch.as_tensor(c), 5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsel_vec(jnp.asarray(vec), jnp.asarray(c), 5)))


def test_oracle_stages_equal_reference(world):
    """Oracle.smems / chains / regs and the scalar ksw_extend /
    ksw_global: the port's wrappers against the reference package's."""
    jorc = joracle.Oracle(world["jidx"])
    batch = reads(world["fwd"], "noisy", True)
    for b in range(8):
        seq = batch.seqs[b][: batch.lens[b]]
        np.testing.assert_array_equal(world["orc"].smems(seq, OPT),
                                      jorc.smems(seq, JOPT))
        for flt in (True, False):
            np.testing.assert_array_equal(
                world["orc"].chains(seq, OPT, filtered=flt),
                jorc.chains(seq, JOPT, filtered=flt))
        for stage in (0, 1, 2):
            np.testing.assert_array_equal(
                world["orc"].regs(seq, OPT, read_id=b, stage=stage),
                jorc.regs(seq, JOPT, read_id=b, stage=stage))
    rng = np.random.default_rng(5)
    for i in range(24):
        t = rng.integers(0, 4, int(rng.integers(20, 120))).astype(np.uint8)
        q = t[: int(rng.integers(10, len(t)))].copy()
        q[rng.integers(0, len(q), 3)] = rng.integers(0, 4, 3)
        kw = dict(w=int(rng.integers(5, 60)), end_bonus=5, h0=int(i * 3))
        assert oracle.ksw_extend(q, t, OPT, **kw) == \
            joracle.ksw_extend(q, t, JOPT, **kw)
        assert oracle.ksw_global(q, t, OPT, w=kw["w"]) == \
            joracle.ksw_global(q, t, JOPT, w=kw["w"])


def test_anchor_aligner_sam_equals_reference_and_oracle():
    """Aligner(seed_impl="anchor") end to end: SAM byte-equal to
    tpubwa.Aligner(seed_impl="anchor") and to the oracle (the world of
    the reference's anchor-path check: 30 kbp, 100 bp reads)."""
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    g[20000:20300] = g[4000:4300]
    jidx = build_index([("chrA", dna.decode(g))])
    aln = Aligner(port_index(jidx), seed_impl="anchor", device="cpu")
    assert aln.lut is None and isinstance(aln.scfg, AnchorSeedConfig)
    recs = jfastx.simulate_reads(g, 40, read_len=100, error_rate=0.02,
                                 indel_rate=0.002, seed=8)
    recs += [jfastx.FastxRecord(f"rep{p}", dna.decode(g[p:p + 100]))
             for p in (4000, 20100)]
    batch = fastx.batch_reads([fastx.FastxRecord(r.name, r.seq)
                               for r in recs])
    got = aln.align_se(batch, id0=3)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=3)
    assert got == JAligner(jidx, seed_impl="anchor").align_se(batch, id0=3)
    assert aln.stats["fallback_reads"] == 0
    # the unpacked device half is what worker1_packed packs
    seqs = torch.as_tensor(batch.seqs).to(torch.int32)
    lens = torch.as_tensor(batch.lens)
    st = aln.worker1_device(seqs, lens)
    assert torch.equal(
        _pack(st, st["l_rep"], aln.ecfg.max_regs, 4 * batch.n),
        aln.worker1_packed(batch.seqs, batch.lens))
    st2 = aln.worker1_device_inner(aln.didx, seqs, lens)
    assert all(torch.equal(st[k], st2[k]) for k in st)
