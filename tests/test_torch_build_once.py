"""Files that several processes of the port or its tests build or read at
once appear whole.

torch_cpu.build_once serialises a build function across processes, so
that one which skips fresh products builds once and no process reads a
half-written one; the reference's oracle library is built that way when
torch_cpu is imported. The port's own caches (the k-mer LUT cache that
--multihost processes share, the bench world's index) are written to a
temporary file and renamed into place: a writer that fails leaves neither
the cache nor its temporary file, and the LUT cache keeps the file format
that the reference reads and writes under the same name.
"""
import ctypes
import functools
import multiprocessing as mp
import os
import time
from pathlib import Path

import numpy as np
import pytest

import torch_cpu
from tpubwa.index.builder import build_index as j_build_index
from tpubwa.seed import lut as jlut
from tpubwa_torch.index.builder import build_index
from tpubwa_torch.seed import lut
from tpubwa_torch.tools import bench_world
from tpubwa_torch.utils import dna

REPO = Path(__file__).resolve().parents[1]
PROCS = 4
CHUNK = 64 * 1024
CHUNKS = 16                       # 1 MiB a build
TIMEOUT_S = 30                    # from the barrier to the last report
START_S = 120                     # for the processes' imports


def slow_build(out: str, log: str):
    """A build like tpubwa.oracle.get_lib: nothing to do when ``out``
    exists, else one line in ``log`` and 1 MiB written in place, in chunks
    with short sleeps between them."""
    out = Path(out)
    if out.exists():
        return
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(out, "wb") as f:
        for _ in range(CHUNKS):
            f.write(b"\x01" * CHUNK)
            f.flush()
            time.sleep(0.02)


def racer(lock: str, out: str, log: str, barrier, sizes):
    """One of the processes of the race: wait for the others, build under
    the lock, then report how many bytes the product holds."""
    barrier.wait(timeout=START_S)
    torch_cpu.build_once(lock, functools.partial(slow_build, out, log))
    sizes.put(len(Path(out).read_bytes()))


def test_processes_at_one_barrier_build_once(tmp_path):
    """Spawned, not forked: forking a process that imported JAX can hang.
    The processes and this one meet at the barrier once their imports are
    done; from there a lock that is never released fails the test within
    TIMEOUT_S."""
    ctx = mp.get_context("spawn")
    barrier, sizes = ctx.Barrier(PROCS + 1), ctx.Queue()
    out, log = tmp_path / "lib.so", tmp_path / "builds.log"
    lock = tmp_path / "sub" / "lib.so.lock"     # its directory is made
    procs = [ctx.Process(target=racer, args=(str(lock), str(out), str(log),
                                             barrier, sizes))
             for _ in range(PROCS)]
    for p in procs:
        p.start()
    try:
        barrier.wait(timeout=START_S)
        deadline = time.monotonic() + TIMEOUT_S
        got = [sizes.get(timeout=max(0.1, deadline - time.monotonic()))
               for _ in procs]
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * PROCS
    assert len(log.read_text().splitlines()) == 1
    assert got == [CHUNK * CHUNKS] * PROCS


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(12)
    return dna.decode(rng.integers(0, 4, 20_000).astype(np.uint8))


def truncating(real):
    """``real`` (np.savez or np.savez_compressed) that writes its file,
    cuts it to 100 bytes and raises, as a full disk or a kill would."""
    def save(file, *args, **kw):
        real(file, *args, **kw)
        with open(file, "r+b") as f:
            f.truncate(100)
        raise OSError("no space left on device")
    return save


@pytest.mark.parametrize("cache", ["lut", "bench_index"])
def test_a_failed_write_leaves_no_cache(cache, genome, tmp_path,
                                        monkeypatch):
    if cache == "lut":
        idx = build_index([("chrT", genome)])
        p = tmp_path / "ref.npz.lut_k.npz"
        monkeypatch.setattr(lut.np, "savez", truncating(np.savez))
        with pytest.raises(OSError, match="no space"):
            lut.KmerLUT.build(idx, cache=p, device="cpu")
    else:
        p = tmp_path / "smoke_index_20000.npz"
        monkeypatch.setattr(np, "savez_compressed",
                            truncating(np.savez_compressed))
        with pytest.raises(OSError, match="no space"):
            bench_world.get_index(tmp_path, 20_000)
    assert not p.exists()
    assert list(p.parent.iterdir()) == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lut_cache_is_shared_with_the_reference(writer, genome, tmp_path,
                                                monkeypatch):
    """The cache one package writes, the other loads (it does not build
    its own) with an equal table."""
    idx, jidx = build_index([("chrT", genome)]), j_build_index(
        [("chrT", genome)])
    p = tmp_path / "ref.npz.lut_k.npz"

    def no_build(*_):
        raise AssertionError("the cache was not loaded")
    if writer == "port":
        want = lut.KmerLUT.build(idx, cache=p, device="cpu").ksp.numpy()
        monkeypatch.setattr(jlut, "build_kmer_lut_arrays", no_build)
        got = np.asarray(jlut.KmerLUT.build(jidx, cache=p).ksp)
    else:
        want = np.asarray(jlut.KmerLUT.build(jidx, cache=p).ksp)
        monkeypatch.setattr(lut, "build_kmer_lut_arrays", no_build)
        got = lut.KmerLUT.build(idx, cache=p, device="cpu").ksp.numpy()
    assert sorted(np.load(p).files) == ["fp", "k0", "ksp"]
    np.testing.assert_array_equal(got, want)


def test_reference_oracle_library_is_built_at_import():
    so = REPO / "build" / "liboracle.so"
    native = REPO / "native"
    srcs = [*native.glob("*.cpp"), *native.glob("*.h")]
    assert so.exists()
    assert so.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)
    ctypes.CDLL(str(so))
    assert torch_cpu.ORACLE_LOCK.exists()
