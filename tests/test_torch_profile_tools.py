"""tpubwa_torch's profiling and rehearsal tools (tools/profile_phases.py,
time_stages.py, time_extend.py, profile_finish.py, profile_pe.py,
parity.py, run_1m.py) on the CPU at a tiny size: each runs to its end,
prints the reference script's row names, and its counts equal what the
reference script computes on the same reads through the reference
package on the CPU: the seeding overflow and SAM line count, every prefix
row's checksum a draw (the read seeds drawn as the port's tool draws
them, where the script draws from os.urandom), the candidate total and
most a read, the 1- and 2-thread finish SAMs, the rescue task count.
parity passes on a clean batch and fails when one line of the oracle's
SAM is altered; run_1m's resumed run starts past batch 0 and its merged
shards equal an uninterrupted run. Without a card every tool raises
unless --platform cpu is given."""
import concurrent.futures as cf
import ctypes as C

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpubwa.chain import device as jchain
from tpubwa.dist.mesh import pe_hist_psum as j_pe_hist_psum
from tpubwa.dist.multihost import hist_allreduce as j_hist_allreduce
from tpubwa.extend import worker as jworker
from tpubwa.index.builder import build_index
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.oracle import to_copt as j_to_copt
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.seed import lut as jlut
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import (bench_world, parity, profile_finish,
                                profile_pe, profile_phases, run_1m,
                                time_extend, time_stages)
from tpubwa_torch.utils import dna, genome

SE_READS = 32
PE_PAIRS = 32


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
        # configs, the function worker1_packed runs at this read length
        return ref_csum(jaln.worker1_packed(seqs, lens))
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


def test_parity_passes_and_fails(world, capsys):
    aln, _ = world
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


def ref_rescue_tasks(jaln, batch) -> int:
    """scripts/profile_pe.py's task count through the reference."""
    buf = np.asarray(jaln.worker1_packed(jnp.asarray(batch.seqs),
                                         jnp.asarray(batch.lens)))
    n, ovf, l_rep, flat = jaln._unpack_host(buf, batch.n)
    if ovf.any():
        n, ovf, l_rep, flat = jaln._tier2(batch, n, ovf, l_rep, flat)
    lib = jaln.oracle._lib
    copt = j_to_copt(jaln.opt.replace(flag=jaln.opt.flag | JMemOptions.F_PE))
    seqs_h = np.ascontiguousarray(batch.seqs, dtype=np.uint8)
    lens_h = np.ascontiguousarray(batch.lens, dtype=np.int32)
    flat_h = np.ascontiguousarray(flat.astype(np.int64))
    n_h = np.ascontiguousarray(n.astype(np.int32))
    lrep_h = np.ascontiguousarray(l_rep.astype(np.int32))
    n_pairs = batch.n // 2
    dirs = np.zeros(max(n_pairs, 1), np.int32)
    isz = np.zeros(max(n_pairs, 1), np.int64)
    lib.tb_pe_isize(jaln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n,
                    seqs_h.shape[1], flat_h, n_h, lrep_h, dirs, isz)
    hist = j_pe_hist_psum(jaln._pe_mesh(), dirs[:n_pairs], isz[:n_pairs],
                          jaln.opt.max_ins)
    hist_h = np.ascontiguousarray(j_hist_allreduce(hist), dtype=np.int64)
    rowsp = C.POINTER(C.c_int64)()
    return int(lib.tb_pe_rescue_tasks(
        jaln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n,
        seqs_h.shape[1], flat_h, n_h, lrep_h,
        hist_h.ctypes.data_as(C.c_void_p), jaln.opt.max_ins, 0,
        C.byref(rowsp)))


def test_profile_pe_counts_equal_reference(world, capsys):
    aln, jaln = world
    r = profile_pe.profile_pe(aln, PE_PAIRS)
    profile_pe.report(r)
    out = capsys.readouterr().out
    for name in profile_pe.STEPS[:3] + ("native_isize", "pestat_psum_device",
                                        "native_pair_sam", "n_rescue_tasks",
                                        "sum_ms", "pe_stream_reads_per_s"):
        assert f"'{name}'" in out
    want = ref_rescue_tasks(jaln, profile_pe.pairs_batch(aln, PE_PAIRS, 2))
    assert r["n_rescue_tasks"] == want > 0
    assert "rescue_kernel" in r
    assert r["rescue_results_missing"] == 0


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


@pytest.mark.parametrize("tool", [profile_phases, time_stages, time_extend,
                                  profile_finish, profile_pe, parity,
                                  run_1m])
def test_the_card_is_required_without_platform_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
