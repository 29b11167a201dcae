"""The port's recorder (``tpubwa_torch/utils/profiling.py``): spans and
counted host syncs on the hot path, with the recorder installed
(``tracing()``) and without it.

The SAM is the same either way; with no recorder nothing is kept; with
one, the stages, tiers, downloads and PE steps appear as span paths and
the blocking reads are counted under them, the same count on every run of
a batch (no count is pinned: a change that removes syncs keeps these
tests). Threads keep their own span stacks, and an event of the profiler's
host activity opened inside a span maps inside its interval with the
benchmark's choice of clock (``benchmark/trace.py::Profile._offset``). The
readers of ``tools/trace_cell.py`` on synthetic traces, and its preview on
the benchmark's small world through the harness.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_pipeline_tiers import GATES, repeat_world, tier_batch
from tpubwa_torch.index.builder import build_index
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import trace_cell
from tpubwa_torch.utils import dna, profiling


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(999)
    g = rng.integers(0, 4, 25000).astype(np.uint8)
    g[12000:12200] = g[4000:4200]
    genome = dna.decode(g)
    aln = Aligner(build_index([("chr1", genome)]), device="cpu")
    fwd = dna.encode(genome)
    se = fastx.batch_reads(fastx.simulate_reads(
        fwd, 64, read_len=100, seed=3, error_rate=0.02), max_len=100)
    pe = fastx.batch_reads(fastx.simulate_reads(
        fwd, 48, read_len=100, paired=True, error_rate=0.02, seed=2),
        max_len=100)
    return aln, se, pe


def run(aln, batch, paired):
    stream = aln.align_pe_stream if paired else aln.align_se_stream
    return "".join(stream([batch]))


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_tracing_leaves_the_sam_unchanged(world, paired):
    aln, se, pe = world
    batch = pe if paired else se
    plain = run(aln, batch, paired)
    with profiling.tracing() as rec:
        traced = run(aln, batch, paired)
    assert traced == plain
    assert rec.summary()["syncs"]


def test_no_recorder_keeps_no_state(world):
    aln, se, pe = world
    with profiling.tracing() as closed:
        pass
    assert profiling._recorder is None
    run(aln, se, False)
    run(aln, pe, True)
    assert closed.summary() == {"totals": {}, "counts": {}, "intervals": [],
                                "syncs": {}, "sync_wait": {},
                                "sync_sites": {}}
    # one shared object does nothing for every span and sync block
    assert profiling.span("seed") is profiling.span("chain") is \
        profiling.synced()
    assert profiling.host_any(torch.tensor([False, True]))
    assert profiling.host_int(torch.tensor(7)) == 7


def test_spans_and_syncs_of_a_batch(world):
    aln, se, pe = world
    with profiling.tracing() as rec:
        run(aln, se, False)
        run(aln, pe, True)
    s = rec.summary()
    want = {"tier1", "tier1/seed", "tier1/chain", "tier1/extend",
            "tier1/pack", "download", "finish", "pe/isize", "pe/tasks",
            "pe/rescue", "pe/sam"}
    assert want <= set(s["totals"]), sorted(s["totals"])
    assert s["syncs"]["tier1/seed"] > 0 and s["syncs"]["tier1/extend"] > 0
    assert s["counts"]["tier1"] == 2 and s["counts"]["finish"] == 1
    # every stage interval lies inside a tier-1 interval of the same thread
    outer = [(a, b) for p, a, b in s["intervals"] if p == "tier1"]
    for p, a, b in s["intervals"]:
        if p.startswith("tier1/"):
            assert any(x <= a and b <= y for x, y in outer), p
    assert sum(s["sync_sites"].values()) == sum(s["syncs"].values())


def test_sync_counts_repeat_over_runs(world):
    aln, se, pe = world
    got = []
    for _ in range(2):
        with profiling.tracing() as rec:
            run(aln, se, False)
            run(aln, pe, True)
        s = rec.summary()
        got.append((s["syncs"], s["sync_sites"], s["counts"]))
    assert got[0] == got[1]


@pytest.mark.parametrize("tier", [2, 3])
def test_big_tier_spans(tier):
    """The repeat read overflows tier 1; the gate of one tier is lowered
    so that that tier re-runs it: its stages appear under its span, and
    the other tier's under none."""
    if tier == 2:
        _, tidx, g, unit = repeat_world(55, 200, 200, 40, 3000, 2)
        batch = tier_batch(g, unit, 6, 2900)
    else:
        _, tidx, g, unit = repeat_world(56, 120, 800, 10, 2000, 1)
        batch = tier_batch(g, unit, 7, 1900)
    aln = Aligner(tidx, device="cpu")
    vars(aln).update(GATES[tier])
    plain = aln.align_se(batch)
    with profiling.tracing() as rec:
        assert aln.align_se(batch) == plain
    s = rec.summary()
    other = 5 - tier
    for stage in ("seed", "chain", "extend", "pack"):
        assert f"tier{tier}/{stage}" in s["totals"]
        assert f"tier{other}/{stage}" not in s["totals"]
    assert s["syncs"][f"tier{tier}/extend"] > 0
    # the tier's download is counted under the tier's own span
    assert s["syncs"][f"tier{tier}"] >= 1
    assert f"tier{other}" not in s["totals"]


def test_threads_keep_their_own_stacks():
    opened, done = threading.Event(), threading.Event()

    def other():
        with profiling.span("b"):
            with profiling.span("c"):
                opened.set()
                done.wait(10)

    with profiling.tracing() as rec:
        with profiling.span("a"):
            t = threading.Thread(target=other)
            t.start()
            assert opened.wait(10)
            with profiling.span("d"):
                assert profiling.host_any(torch.tensor([True]))
            done.set()
            t.join(10)
    assert not t.is_alive()
    s = rec.summary()
    assert set(s["totals"]) == {"a", "a/d", "b", "b/c"}
    assert s["syncs"] == {"a/d": 1}


def test_profiler_event_maps_inside_its_span():
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import Profile
    p = Profile.__new__(Profile)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    p.c0 = Profile._clocks()
    with profiling.tracing() as rec, profiling.span("seed"):
        time.sleep(0.005)
        with record_function("probe"):
            torch.ones(64).sum()
        time.sleep(0.005)
    p.c1 = Profile._clocks()
    prof.__exit__(None, None, None)
    p.events = [(e.start_ns(), e.duration_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.name() == "probe"]
    (start, dur, _), = p.events
    off = p._offset()
    (path, t0, t1), = rec.summary()["intervals"]
    assert path == "seed" and off is not None
    assert t0 + off <= start and start + dur <= t1 + off


def trace_of(totals=None, syncs=None, wait=None, program=True):
    prog = {"totals": totals or {}, "counts": {}, "syncs": syncs or {},
            "sync_wait": wait or {}} if program else None
    return types.SimpleNamespace(window_s=10.0, stats={"reads": 2000},
                                 program=prog)


READ = {"seed_wall_pct": 17.5, "chain_wall_pct": 10.0,
        "extend_wall_pct": 25.0, "tier2_wall_pct": 20.0,
        "tier3_wall_pct": 5.0, "host_syncs_per_kread": 60.0,
        "sync_wait_pct": 30.0}


@pytest.mark.parametrize("name", sorted(READ))
def test_reader(name):
    """Each reader on a trace with the recorder's summary, with none, and
    with a summary in which its span never opened (or no sync)."""
    read = trace_cell.READERS[name]
    full = trace_of(
        {"tier1": 5.0, "tier1/seed": 1.0, "tier3/seed": 0.5,
         "tier1/chain": 1.0, "tier1/extend": 2.0, "tier3/extend": 0.5,
         "tier2": 2.0, "tier2/seed": 0.25, "tier3": 0.5},
        {"tier1/seed": 80, "tier1/extend": 40}, {"tier1/seed": 3.0})
    assert read(full) == pytest.approx(READ[name])
    assert read(trace_of(program=False)) is None
    assert read(trace_of({"download": 1.0}, {}, {})) == 0.0
    assert {m["name"] for m in trace_cell.PROPOSED} == set(READ)


def test_preview_runs_the_harness_with_program_spans(tmp_path):
    """The preview on the benchmark's small world (the program on the CPU):
    its result line holds every proposed metric, which add up within the
    harness's own span shares, and the check still passes."""
    from benchmark.tests import smallworld
    bench = smallworld.make(tmp_path, batch_records=128)
    res = trace_cell.preview(
        bench, "small.se100", 2**31 + 7, 0.5, device="cpu",
        cache=tmp_path / "cache", root=tmp_path, procs=2,
        traffic_dir=tmp_path / "traffic", log=lambda *a, **k: None)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READ) <= set(m)
    assert res["correct"]
    assert m["seed_wall_pct"] + m["chain_wall_pct"] + m["extend_wall_pct"] \
        <= m["worker1_wall_pct"] + m["tiers_wall_pct"] + 1
    assert m["tier2_wall_pct"] + m["tier3_wall_pct"] <= \
        m["tiers_wall_pct"] + 1
    assert m["host_syncs_per_kread"] > 0 and m["sync_wait_pct"] <= 100
    assert "tier1/seed" in res["program"]["totals"]
