"""Multi-host orchestration (BASELINE config 4 scaffolding).

The reference ran one Spark executor per node with HDFS-distributed input
(SURVEY.md §1 S1/S2). Here: one process per host (or per card), per-host
FASTQ shards (no network filesystem), per-host SAM shard files, and a
deterministic merge (`python -m tpubwa_torch merge`). The only cross-host
traffic at run time is the sum of the insert-size histogram of every PE
batch; everything else is embarrassingly parallel.

The processes meet at a ``torch.distributed.TCPStore``, a key-value store
that rank 0 hosts: no process group and no NCCL are needed for a
histogram of a few hundred KB once per batch, and hosts can be minutes
apart (the first batch's kernel builds). The environment is the one
``torchrun`` sets: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK.

Every cross-host call blocks on the store with a timeout and raises when
it expires: a process never goes on alone.
"""
from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np

DEFAULT_PORT = 29500
STORE_TIMEOUT_S = 1800     # rank 0 waits this long for every process


def host_shard_of(paths: list[str | Path], process_id: int,
                  num_processes: int) -> list[Path]:
    """Static per-host split of input FASTQ files (the HDFS-chunk analog).

    Files are assigned round-robin by sorted order so every host computes
    the same assignment without communication.
    """
    ordered = sorted(Path(p) for p in paths)
    return [p for i, p in enumerate(ordered)
            if i % num_processes == process_id]


def shard_output_path(base: str | Path, process_id: int) -> Path:
    """Per-host SAM shard path; merge the shards with the `merge` command."""
    base = Path(base)
    return base.with_name(f"{base.stem}.host{process_id:04d}{base.suffix}")


class HostGroup:
    """One process's view of the hosts of a run: its rank, the number of
    hosts, the store they share (None on a single host), and the state of
    the PE histogram reduction: seq = next reduce round, total = the
    agreed global batch count (None until pe_plan), shape = the
    histogram's shape for zero-contribution rounds."""

    def __init__(self, store=None, rank: int = 0, world: int = 1):
        self.store, self.rank, self.world = store, rank, world
        self.seq = 0
        self.total: int | None = None
        self.shape: tuple[int, int] | None = None

    def _get(self, key: str, timeout_ms: int) -> bytes:
        """The value of key once some host has set it; raises when it does
        not appear within timeout_ms."""
        try:
            self.store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        except RuntimeError as e:
            raise RuntimeError(
                f"multihost: host {self.rank} waited {timeout_ms} ms for "
                f"{key!r} on the store; another host failed or is stuck") \
                from e
        return self.store.get(key)

    def barrier(self, name: str, timeout_ms: int = 1_800_000) -> None:
        """Store barrier across processes (no-op single-process). Used at
        the end of a multihost run so hosts with very different batch or
        build times leave together."""
        if self.world == 1:
            return
        self.store.set(f"tpubwa/barrier/{name}/{self.rank}", "1")
        for p in range(self.world):
            self._get(f"tpubwa/barrier/{name}/{p}", timeout_ms)

    def pe_plan(self, n_batches: int, max_ins: int,
                timeout_ms: int = 600_000) -> int:
        """Agree on the global PE reduce-round count BEFORE aligning.

        Every host announces how many PE batches it will process; the global
        round count is the max. Hosts with fewer batches take part in the
        remaining rounds with zero histograms (pe_drain), so uneven per-host
        inputs — round-robin file sharding with an odd file count, or
        --shard-dir resume skipping different numbers of batches per host —
        cannot deadlock or silently mis-pair the reduction.

        Returns the global round count. Single-process: records the plan and
        returns n_batches.
        """
        self.seq = 0
        self.shape = (4, max_ins + 1)
        if self.world == 1:
            self.total = int(n_batches)
            return self.total
        self.store.set(f"tpubwa/pe_plan/{self.rank}", str(int(n_batches)))
        self.total = max(int(self._get(f"tpubwa/pe_plan/{p}", timeout_ms))
                         for p in range(self.world))
        return self.total

    def pe_drain(self) -> None:
        """Take part with zero histograms in the reduce rounds of hosts that
        have more PE batches than this one; call after the host's last
        batch. No-op without a pe_plan or when this host had the most
        batches."""
        if self.total is None:
            return
        while self.seq < self.total:
            self.hist_allreduce(np.zeros(self.shape, np.int64))
        self.total = None

    def hist_skip(self) -> None:
        """Zero-contribution reduce for a batch this host skips (a
        --shard-dir manifest hit on resume): keeps every host's reduce
        sequence aligned to the global batch ordinal."""
        if self.shape is None:
            raise RuntimeError("hist_skip() requires a pe_plan()")
        self.hist_allreduce(np.zeros(self.shape, np.int64))

    def hist_allreduce(self, hist, timeout_ms: int = 600_000):
        """Sum per-host insert-size histograms across processes — the
        cross-host leg of the reference's Spark collect+broadcast [ref:
        FastMap.memPairEndMapping pestat collect; SURVEY.md §5.8].

        Single-process: counts the round and returns hist unchanged. In a
        multi-process run every host calls this once per global batch
        ordinal, in order (one key per host and round); uneven per-host
        batch counts are handled by pe_plan + pe_drain / hist_skip (zero
        contributions), and over-running an agreed plan raises instead of
        blocking on a key that will never arrive.
        """
        if self.world == 1:
            self.seq += 1
            return hist
        seq = self.seq
        if self.total is not None and seq >= self.total:
            raise RuntimeError(
                f"hist_allreduce round {seq} exceeds the agreed pe_plan of "
                f"{self.total} rounds — per-host batch counts diverged from "
                "the plan")
        self.seq = seq + 1
        h = np.ascontiguousarray(hist, dtype=np.int64)
        self.store.set(f"tpubwa/pestat/{seq}/{self.rank}", h.tobytes())
        total = np.zeros_like(h)
        for p in range(self.world):
            raw = self._get(f"tpubwa/pestat/{seq}/{p}", timeout_ms)
            total += np.frombuffer(raw, np.int64).reshape(h.shape)
        # Completing round `seq` proves every host finished round seq-1
        # (each published its seq key only after reading all seq-1 keys),
        # so our own seq-1 key can no longer be awaited by anyone: delete
        # it to bound the store's memory over long runs.
        if seq > 0:
            self.store.delete_key(f"tpubwa/pestat/{seq - 1}/{self.rank}")
        return total


# this process's group; initialize() replaces it on a multi-host run
_group = HostGroup()


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Connect this process to the run's store (no-op on a single host).

    Returns (process_id, num_processes). The arguments default from the
    environment ``torchrun`` sets: coordinator = MASTER_ADDR:MASTER_PORT
    (port 29500 when unset), num_processes = WORLD_SIZE, process_id = RANK.
    Without a coordinator, or with one process, the run is single-host and
    this returns (0, 1). Rank 0 hosts the store and waits until every
    process has connected.
    """
    global _group
    import torch.distributed as dist

    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', DEFAULT_PORT)}")
    n = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator is None or n <= 1:
        _group = HostGroup()
        return 0, 1
    pid = process_id if process_id is not None else int(os.environ["RANK"])
    host, _, port = coordinator.rpartition(":")
    store = dist.TCPStore(host, int(port), n, pid == 0,
                          timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S),
                          wait_for_workers=True)
    _group = HostGroup(store, pid, n)
    return pid, n


def barrier(name: str, timeout_ms: int = 1_800_000) -> None:
    _group.barrier(name, timeout_ms)


def pe_plan(n_batches: int, max_ins: int, timeout_ms: int = 600_000) -> int:
    return _group.pe_plan(n_batches, max_ins, timeout_ms)


def pe_drain() -> None:
    _group.pe_drain()


def hist_skip() -> None:
    _group.hist_skip()


def hist_allreduce(hist, timeout_ms: int = 600_000):
    return _group.hist_allreduce(hist, timeout_ms)
