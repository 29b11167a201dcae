"""tpubwa_torch's single-end profiling tools (tools/profile_phases.py,
time_stages.py, time_extend.py, profile_finish.py) on the CPU at a tiny
size: each runs to its end, prints the reference script's row names, and
its counts equal what the reference script computes on the same reads
through the reference package on the CPU: the seeding overflow and SAM
line count, every prefix row's checksum a draw (the read seeds drawn as
the port's tool draws them, where the script draws from os.urandom), the
candidate total and most a read, the 1- and 2-thread finish SAMs. The
reference's calls share two compiled shapes, its stage chain and its
packed worker1 on SE_READS x 100 bp. Without a card every tool raises
unless --platform cpu is given. profile_pe is held in
test_torch_profile_pe.py, parity and run_1m in
test_torch_profile_rehearsal.py."""
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.chain import device as jchain
from tpubwa.extend import worker as jworker
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.seed import lut as jlut
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import (bench_world, profile_finish, profile_phases,
                                time_extend, time_stages)
from tpubwa_torch.utils import dna, genome

SE_READS = 32


@pytest.fixture(scope="module")
def world():
    """A 120 kbp genome of the bench world's (bacterial) profile, its
    index on both sides and an aligner of each."""
    g = genome.synthetic_genome(120_000, seed=5, profile=genome.BACTERIAL)
    jidx = build_index([("bench_synth", dna.decode(g))])
    tidx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return Aligner(tidx, device="cpu"), JAligner(jidx)


def ref_csum(tree):
    """scripts/time_stages.py's csum."""
    leaves = [x for x in jax.tree_util.tree_leaves(tree)
              if hasattr(x, "dtype")]
    tot = jnp.int32(0)
    for x in leaves:
        tot = tot + jnp.sum(x.astype(jnp.int32), dtype=jnp.int32)
    return int(tot)


def draws(seed, k):
    """The read seeds of k successive draws, as the port's tools draw."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 1 << 30)) for _ in range(k)]


def ref_stages(jaln, batch):
    """The reference's stage outputs on a batch: (smems, seeds, chains,
    filter, extension state), one jit for the module's shape."""
    def f(d, lu, s, le):
        sm = jlut.collect_smems_lut(d, lu, s, le, jaln.scfg)
        sd = jchain.seeds_from_smems(d, sm, jaln.ccfg)
        ch = jchain.chain_seeds(d, sd, jaln.ccfg)
        flt = jchain.chain_filter(ch, jaln.ccfg)
        return sm, sd, ch, flt, jworker.extend_chains(
            d, s, le, sd, ch, jaln.ecfg, flt)
    fn = vars(jaln).setdefault("_stages_jit", jax.jit(f))
    return fn(jaln.didx, jaln.lut, jnp.asarray(batch.seqs.astype(np.int32)),
              jnp.asarray(batch.lens.astype(np.int32)))


def test_profile_phases_counts_equal_reference(world, capsys):
    aln, jaln = world
    batch = bench_world.reads(aln.idx, SE_READS)
    r = profile_phases.profile_phases(aln, batch)
    profile_phases.report(r)
    out = capsys.readouterr().out
    for name in profile_phases.ROWS:
        assert name in out
    assert [row["row"] for row in r["rows"]] == list(profile_phases.ROWS)
    sm = ref_stages(jaln, batch)[0]
    assert r["seed_overflows"] == int(np.asarray(sm["overflow"]).sum())
    assert r["sam_lines"] == jaln.align_se(batch).count("\n") >= SE_READS
    assert f"seed overflows: {r['seed_overflows']}" in out


def ref_row(jaln, batch, k: int) -> int:
    """scripts/time_stages.py's checksum of row k on one batch."""
    seqs = jnp.asarray(batch.seqs.astype(np.int32))
    lens = jnp.asarray(batch.lens.astype(np.int32))
    cuts = time_stages.WALK_CUTS
    if k < len(cuts):
        walks = vars(jaln).setdefault("_walk_jits", {})
        if k not in walks:
            walks[k] = jax.jit(lambda d, lu, s, le, v: jlut._walk_lut(
                d, lu, s, le, v, True, jaln.scfg, _stop_after=cuts[k]))
        return ref_csum(walks[k](jaln.didx, jaln.lut, seqs, lens,
                                 jnp.ones((batch.n,), jnp.int32)))
    if k == len(time_stages.ROWS) - 1:
        # the script's packed row is _make_packed with the aligner's
        # configs, the function worker1_packed runs at this read length;
        # uint8 reads, as align_se passes them, reuse its compiled call
        # (the packed call widens them to int32 first)
        return ref_csum(jaln.worker1_packed(jnp.asarray(batch.seqs),
                                            jnp.asarray(batch.lens)))
    sm, sd, ch, flt, st = ref_stages(jaln, batch)
    return ref_csum((sm, sd, ch, (ch, flt), st)[k - len(cuts)])


def test_time_stages_checksums_equal_reference(world, capsys):
    aln, jaln = world
    r = time_stages.time_stages(aln, SE_READS, seed=11, reps=1)
    time_stages.report(r)
    out = capsys.readouterr().out
    assert [row["row"] for row in r["rows"]] == list(time_stages.ROWS)
    for name in time_stages.ROWS:
        assert name in out
    seeds = draws(11, 2 * len(time_stages.ROWS))
    for k, row in enumerate(r["rows"]):
        want = [ref_row(jaln, bench_world.reads(aln.idx, SE_READS, s), k)
                for s in seeds[2 * k: 2 * k + 2]]
        assert row["csums"] == want, row["row"]


def test_csum_wraps_as_int32():
    x = torch.tensor([2**31 - 1, 5, 2**40 + 3], dtype=torch.int64)
    want = int(jnp.sum(jnp.asarray(x.numpy()).astype(jnp.int32),
                       dtype=jnp.int32))
    got = time_stages.csum({"a": x, "b": (torch.tensor([True, True]), 7)})
    assert got.dtype == torch.int32
    assert int(got) == np.int32(np.int64(want) + 9)


@pytest.mark.parametrize("round_engine", [False, True],
                         ids=["task_parallel", "round"])
def test_time_extend_rows_and_candidates(world, capsys, round_engine):
    aln, jaln = world
    rec = []
    r = time_extend.time_extend(aln, SE_READS, round_engine, seed=4,
                                reps=1, record=rec)
    time_extend.report(r)
    out = capsys.readouterr().out
    table = time_extend.ROUND_ROWS if round_engine else \
        time_extend.TASK_PARALLEL_ROWS
    names = [n for n, _ in table] + ["windows only(x4)",
                                     time_extend.KERNEL_ROW]
    assert [row["row"] for row in r["rows"]] == names
    for name in names:
        assert name in out
    # the kernel row's inputs: the script's synthetic tasks at WREF
    q, ql, t, tl, h0, w, eb, act = rec[0]
    W = r["wref"]
    assert t.shape == (SE_READS, W) and (t[3] == torch.arange(W) % 4).all()
    assert tl[5] == 100 + (5 * 37) % (W - 100)
    assert (h0 == 19).all() and (w == 100).all() and (eb == 5).all()
    if round_engine:
        assert r["engine"] == "round" and "candidates" not in r
        return
    # scripts/time_extend.py's cand_fn on the same reads
    b = bench_world.reads(aln.idx, SE_READS, draws(5, 1)[0])
    sm, sd, ch, flt, _ = ref_stages(jaln, b)
    st = jworker.extend_chains(
        jaln.didx, jnp.asarray(b.seqs.astype(np.int32)),
        jnp.asarray(b.lens.astype(np.int32)), sd, ch, jaln.ecfg, flt,
        _stop_after="tp2")
    assert r["candidates"] == {"total": int(st["n"].sum()),
                               "max_per_read": int(st["n"].max())}
    assert f"candidates: total={r['candidates']['total']}" in out


def test_profile_finish_sams_equal_reference(world, capsys):
    aln, jaln = world
    batch = bench_world.reads(aln.idx, SE_READS)
    r = profile_finish.profile_finish(aln, batch)
    profile_finish.report(r)
    out = capsys.readouterr().out
    for name in ("_unpack_host:", "native finish (1t):",
                 "native finish (2t):", "_finish_se_buf:"):
        assert name in out
    # scripts/profile_finish.py's computation through the reference
    buf = np.asarray(jaln.worker1_packed(jnp.asarray(batch.seqs),
                                         jnp.asarray(batch.lens)))
    n2, ovf2, lrep2, flat2 = jaln._unpack_host(buf, batch.n)
    if ovf2.any():
        n2, ovf2, lrep2, flat2 = jaln._tier2(batch, n2, ovf2, lrep2, flat2)
    offs = np.concatenate([[0], np.cumsum(n2)])
    sam1 = jaln._finish_chunk(batch, n2, ovf2, lrep2, flat2, offs, 0,
                              batch.n, 0, jaln.oracle)
    oracles = jaln._finish_oracles(2)
    bounds = [round(batch.n * i / 2) for i in range(3)]
    with cf.ThreadPoolExecutor(max_workers=2) as ex:
        sam2 = "".join(ex.submit(
            jaln._finish_chunk, batch, n2, ovf2, lrep2, flat2, offs,
            bounds[i], bounds[i + 1], 0, oracles[i]).result()
            for i in range(2))
    assert r["sam_1t"] == sam1 and r["sam_2t"] == sam2 == sam1
    # the uncut path against the oracle, as chip_smoke.py's phase 17 holds it
    assert r["sam_1t"] == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert r["regs"] == len(flat2) and r["ovf"] == int(ovf2.sum())


@pytest.mark.parametrize("tool", [profile_phases, time_stages, time_extend,
                                  profile_finish])
def test_the_card_is_required_without_platform_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
