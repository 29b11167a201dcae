"""tpubwa_torch's multi-host layer: the store protocol, and two real
processes of the command line.

The protocol (dist/multihost.py) runs two "hosts" as threads against one
torch.distributed.TCPStore: the agreed PE plan, uneven drains, skipped
batches, the overrun error, key deletion, barriers and timeouts. Then
two processes of ``python -m tpubwa_torch.cli align --multihost`` on SE
and on uneven PE input, whose merged shards must be byte-equal to
single-process runs of the port's command line, and so of the reference
package's. Free ports come from binding port 0.
"""
import datetime
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
import tpubwa.cli as jcli
from tpubwa.dist import multihost as jmultihost
from tpubwa_torch import cli
from tpubwa_torch.dist import multihost
from tpubwa_torch.dist.multihost import HostGroup
from tpubwa_torch.index.builder import build_index
from tpubwa_torch.io import fastx
from tpubwa_torch.utils import dna

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_without_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() == (0, 1)
    # one process is a single host too, with or without an address
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() == (0, 1)
    assert multihost.hist_allreduce(np.ones((4, 3))).sum() == 12


def test_host_shard_of_and_shard_output_path():
    paths = [f"r{i}.fq" for i in range(10)]
    for n in (1, 3, 4):
        for p in range(n):
            assert multihost.host_shard_of(paths[::-1], p, n) == \
                jmultihost.host_shard_of(paths, p, n)
        flat = sorted(str(x) for p in range(n)
                      for x in multihost.host_shard_of(paths, p, n))
        assert flat == sorted(paths)
    for base, pid in (("out/run.sam", 3), ("x.sam", 0), ("a/b", 12)):
        assert multihost.shard_output_path(base, pid) == \
            jmultihost.shard_output_path(base, pid)
    assert multihost.shard_output_path("out/run.sam", 3).name == \
        "run.host0003.sam"


@pytest.fixture
def stores():
    """A store served by 'host 0' and a client of it for 'host 1'."""
    t = datetime.timedelta(seconds=30)
    master = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=t,
                           wait_for_workers=False)
    client = dist.TCPStore("127.0.0.1", master.port, 2, False, timeout=t)
    return master, client


def on_threads(*fns):
    """Run fns concurrently; return their results, re-raising errors."""
    out, errs = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:     # re-raised below
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    if errs:
        raise errs[0]
    return out


def hist(seed):
    return np.random.default_rng(seed).integers(0, 9, (4, 6)).astype(
        np.int64)


def test_single_host_counts_rounds():
    g = HostGroup()
    assert g.pe_plan(3, 5) == 3
    h = hist(0)
    assert g.hist_allreduce(h) is h and g.seq == 1
    g.hist_skip()
    g.pe_drain()
    assert g.seq == 3 and g.total is None
    g.barrier("x")


def test_uneven_plan_drain_and_key_deletion(stores):
    """Host 0 has 3 batches, host 1 has 1: the global plan is 3 rounds;
    round 0 sums both, rounds 1-2 add host 1's zeros from pe_drain."""
    h0, h1 = HostGroup(stores[0], 0, 2), HostGroup(stores[1], 1, 2)

    def host0():
        assert h0.pe_plan(3, 5) == 3
        sums = [h0.hist_allreduce(hist(r)) for r in range(3)]
        h0.pe_drain()
        h0.barrier("done")
        return sums

    def host1():
        assert h1.pe_plan(1, 5) == 3
        s = h1.hist_allreduce(hist(10))
        h1.pe_drain()
        h1.barrier("done")
        return s

    sums, s1 = on_threads(host0, host1)
    np.testing.assert_array_equal(sums[0], hist(0) + hist(10))
    np.testing.assert_array_equal(s1, sums[0])
    np.testing.assert_array_equal(sums[1], hist(1))
    np.testing.assert_array_equal(sums[2], hist(2))
    assert h0.seq == h1.seq == 3 and h1.total is None
    # after round r each host deleted its own key of round r-1
    st = stores[0]
    for r in (0, 1):
        assert not st.check([f"tpubwa/pestat/{r}/0",
                             f"tpubwa/pestat/{r}/1"])
    assert st.check(["tpubwa/pestat/2/0"]) and \
        st.check(["tpubwa/pestat/2/1"])


def test_hist_skip_keeps_rounds_aligned(stores):
    """A host that skips its first batch (a resumed shard) adds zeros to
    that round."""
    h0, h1 = HostGroup(stores[0], 0, 2), HostGroup(stores[1], 1, 2)

    def host0():
        h0.pe_plan(2, 5)
        return [h0.hist_allreduce(hist(r)) for r in range(2)]

    def host1():
        h1.pe_plan(2, 5)
        h1.hist_skip()
        return h1.hist_allreduce(hist(7))

    sums, last = on_threads(host0, host1)
    np.testing.assert_array_equal(sums[0], hist(0))
    np.testing.assert_array_equal(sums[1], hist(1) + hist(7))
    np.testing.assert_array_equal(last, sums[1])
    with pytest.raises(RuntimeError, match="requires a pe_plan"):
        HostGroup(stores[0], 0, 2).hist_skip()


def test_overrun_raises_instead_of_blocking(stores):
    h0, h1 = HostGroup(stores[0], 0, 2), HostGroup(stores[1], 1, 2)
    on_threads(lambda: (h0.pe_plan(1, 5), h0.hist_allreduce(hist(0))),
               lambda: (h1.pe_plan(1, 5), h1.hist_allreduce(hist(1))))
    with pytest.raises(RuntimeError, match="exceeds the agreed pe_plan"):
        h0.hist_allreduce(hist(2))


def test_a_missing_host_times_out(stores):
    """A host whose peer never arrives raises; it does not go on alone."""
    h0 = HostGroup(stores[0], 0, 2)
    with pytest.raises(RuntimeError, match="waited 300 ms"):
        h0.barrier("never", timeout_ms=300)
    with pytest.raises(RuntimeError, match="tpubwa/pe_plan/1"):
        h0.pe_plan(2, 5, timeout_ms=300)


# ---------------------------------------------------------------------------
# two real processes of the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(77)
    g = rng.integers(0, 4, 40000).astype(np.uint8)
    build_index([("chrM", dna.decode(g))]).save(d / "ref.npz")
    return d, g


def body(path) -> str:
    return "".join(l for l in Path(path).read_text().splitlines(True)
                   if not l.startswith("@"))


def launch_pair(argv0, argv1):
    """Two processes of the port's command line joined by a store on a
    free local port; both must exit 0."""
    port = str(free_port())
    procs = []
    for rank, argv in enumerate((argv0, argv1)):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(rank),
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + os.environ.get("PYTHONPATH", "")
                       .split(os.pathsep)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpubwa_torch.cli", *argv], cwd=str(REPO),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def test_two_processes_se_equal_single(world):
    d, g = world
    recs = fastx.simulate_reads(g, 32, read_len=100, error_rate=0.01,
                                seed=21)
    fastx.write_fastq(d / "a.fq", recs[:16])
    fastx.write_fastq(d / "b.fq", recs[16:])
    single = ["align", "--se", "--platform", "cpu", "--batch-size", "8",
              str(d / "ref.npz"), str(d / "a.fq"), str(d / "b.fq")]
    assert cli.main(single + ["-o", str(d / "single.sam")]) == 0
    assert jcli.main(single + ["-o", str(d / "ref.sam"), "--oracle"]) == 0
    assert body(d / "single.sam") == body(d / "ref.sam")
    mh = ["align", "--multihost", "--platform", "cpu", "--batch-size", "8",
          str(d / "ref.npz"), str(d / "a.fq"), str(d / "b.fq"),
          "-o", str(d / "mh.sam")]
    launch_pair(mh + ["--id0", "0"], mh + ["--id0", "16"])
    merged = body(d / "mh.host0000.sam") + body(d / "mh.host0001.sam")
    assert merged == body(d / "single.sam")
    assert merged.count("\n") >= 32


def test_two_processes_uneven_pe_sum_the_histogram(world):
    """Host 0 aligns files 0 and 2 (3 batches of 6 pairs), host 1 file 1
    (1 batch of 6 pairs). Round 0 sums batch 0 of both hosts, so their SAM
    equals one single-process batch over files 0 and 1 together (S1);
    host 0's batches 1-2 are alone in their rounds, as in a single-process
    run of file 2 (S2). Read ids match: host 1 starts at read 12. Six
    pairs alone give no insert-size estimate (fewer than 10 samples),
    twelve do, so the equality needs the cross-process sum."""
    d, g = world
    recs = fastx.simulate_reads(g, 24, read_len=100, paired=True,
                                error_rate=0.01, seed=23, insert_mean=320,
                                insert_std=25)
    fastx.write_fastq(d / "u0.fq", recs[:12])      # 6 pairs
    fastx.write_fastq(d / "u1.fq", recs[12:24])    # 6 pairs
    fastx.write_fastq(d / "u2.fq", recs[24:])      # 12 pairs
    npz = str(d / "ref.npz")
    base = ["-p", "--platform", "cpu", npz]
    runs = {"s1": base + ["--batch-size", "24", str(d / "u0.fq"),
                          str(d / "u1.fq")],
            "s2": base + ["--batch-size", "12", "--id0", "12",
                          str(d / "u2.fq")],
            "alone": base + ["--batch-size", "12", str(d / "u0.fq")]}
    for name, args in runs.items():
        assert cli.main(["align", *args, "-o", str(d / f"{name}.sam")]) == 0
    for name in ("s1", "s2"):
        assert jcli.main(["align", *runs[name], "--oracle", "-o",
                          str(d / f"{name}.ref.sam")]) == 0
        assert body(d / f"{name}.sam") == body(d / f"{name}.ref.sam")
    mh = ["align", "-p", "--multihost", "--platform", "cpu", "--batch-size",
          "12", npz, str(d / "u0.fq"), str(d / "u1.fq"), str(d / "u2.fq"),
          "-o", str(d / "pe_mh.sam")]
    launch_pair(mh + ["--id0", "0"], mh + ["--id0", "12"])
    s1 = body(d / "s1.sam").splitlines(True)
    cut = next(i for i, l in enumerate(s1)
               if l.split("\t")[0] == recs[12].name)
    assert body(d / "pe_mh.host0000.sam") == \
        "".join(s1[:cut]) + body(d / "s2.sam")
    assert body(d / "pe_mh.host0001.sam") == "".join(s1[cut:])
    assert "\t99\t" in "".join(s1[:cut])
    assert body(d / "alone.sam") != "".join(s1[:cut])
