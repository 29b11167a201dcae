"""Device-level data parallelism: worker1 over a mesh of devices, and the
reductions over the reads of a batch.

The reference's only compute parallelism is data parallelism over reads
(Spark partitions of FASTQ chunks, SURVEY.md §2.5): a 1-D ``reads`` mesh
axis splits the batch, the FM-index is replicated onto every device (the
``sc.broadcast(bwaIdx)`` analog), and the one true cross-device reduction,
the pair-end insert-size histogram [bwa: bwamem_pair.c :: mem_pestat], is a
sum of per-device histograms.

The mesh is driven by one process, like ``shard_map``: one controller
thread, and a worker thread (and on a card a stream) for each distinct
device of the mesh; no process group and no NCCL.
A sum over shards is the only collective any caller needs (the sharded
index's probes replicate their queries and sum the answers), and it is a
copy of each partial result to the controller followed by an add. A device
may appear more than once in a mesh: ``Mesh((torch.device("cuda", 0),) * 4)``
gives four logical shards on one card, ``make_mesh(8, device="cpu")`` eight
on the host. Multi-process runs are ``dist.multihost``'s.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses

import numpy as np
import torch

from ..chain.device import chain_filter, chain_seeds, seeds_from_smems
from ..extend.worker import extend_chains
from ..seed.anchor import collect_smems_anchor
from ..seed.lut import LutSeedConfig, collect_smems_lut
from ..utils.profiling import span, synced

READS_AXIS = "reads"


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D mesh: an ordered tuple of devices along one named axis. Entry i
    owns block i of whatever is split along the axis.

    The mesh also keeps the replicas ``replicate`` made, so that every
    later call with the same object copies nothing, and one stream per
    card (``stream``)."""
    devices: tuple
    axis: str = READS_AXIS

    def __post_init__(self):
        devs = []
        for d in self.devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("Mesh: no devices")
        self.devices = tuple(devs)
        self._replicas = {}
        self._streams = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def replicate(self, obj) -> dict:
        """{device: obj.to(device)} over the mesh's distinct devices. Made
        on the first call with ``obj`` and kept (with ``obj``) for the life
        of the mesh; ``obj.to`` is a no-op where obj lies already."""
        got = self._replicas.get(id(obj))
        if got is None or got[0] is not obj:
            got = (obj, {d: obj.to(d) for d in dict.fromkeys(self.devices)})
            self._replicas[id(obj)] = got
        return got[1]


    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The mesh's stream on a card, made at first use and kept: the
        memory the caching allocator holds for a stream stays warm from
        one call to the next."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS,
              local: bool = False, device=None) -> Mesh:
    """The first ``n_devices`` (all by default) of this process's CUDA
    cards, ``cuda:0`` first; raises when there is no card. ``device="cpu"``
    gives ``n_devices`` (default 1) CPU shards instead.

    ``local`` is accepted for the reference's signature and changes
    nothing: a PyTorch process sees only its own cards, so every mesh is
    local."""
    del local
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cpu":
        return Mesh((torch.device("cpu"),) * (n_devices or 1), axis)
    if kind != "cuda":
        raise ValueError(f"make_mesh: device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' for a mesh of CPU shards")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis)


def worker1_step(didx, seqs, lens, lut=None, *, scfg, ccfg, ecfg) -> dict:
    """The full per-shard device step (seed -> chain -> filter -> extend):
    the region state of every read, with l_rep. Each stage is a span of
    the recorder (``utils.profiling``)."""
    with span("seed"):
        if isinstance(scfg, LutSeedConfig):
            smems = collect_smems_lut(didx, lut, seqs, lens, scfg)
        else:
            smems = collect_smems_anchor(didx, seqs, lens, scfg)
    with span("chain"):
        seeds = seeds_from_smems(didx, smems, ccfg)
        ch = chain_seeds(didx, seeds, ccfg)
        flt = chain_filter(ch, ccfg)
    with span("extend"):
        st = extend_chains(didx, seqs, lens, seeds, ch, ecfg, flt)
    return dict(
        n=st["n"], overflow=st["overflow"], rb=st["rb"], re=st["re"],
        qb=st["qb"], qe=st["qe"], score=st["score"], truesc=st["truesc"],
        w=st["w"], seedcov=st["seedcov"], seedlen0=st["seedlen0"],
        rid=st["rid"], l_rep=seeds["l_rep"],
    )


def _blocks(mesh: Mesh, x: torch.Tensor, what: str) -> list:
    """x split along dim 0 into one contiguous block per mesh entry, each
    on its entry's device."""
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"{what}: {x.shape[0]} rows do not divide over "
                         f"{n} mesh entries")
    b = x.shape[0] // n
    return [x[i * b:(i + 1) * b].to(d) for i, d in enumerate(mesh.devices)]


def _run_on(device: torch.device, stream, fn, caller):
    """fn() on ``device``: on a card, on ``stream``, which first waits for
    the caller's stream (where the inputs were made) and is synchronized
    before the result is handed back."""
    if device.type != "cuda":
        return fn()
    with torch.cuda.device(device):
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = fn()
        stream.synchronize()
    return out


def worker1_sharded(mesh: Mesh, didx, seqs, lens, scfg, ccfg, ecfg,
                    lut=None) -> dict:
    """Data-parallel worker1 over the mesh: the reads split into one
    contiguous block per mesh entry, the index (and the k-mer jump table)
    replicated onto every device, no communication between shards. Entry
    i's result is ``worker1_step`` on block i, so a dense budget of the
    step (sized from the block's reads) may flag other reads overflow than
    on the whole batch, as the reference's shard_map does; every read that
    overflows in neither gets the same result.

    Every distinct device gets a thread and (on a card) the mesh's stream
    there, so the devices' host loops and syncs overlap; the entries that
    share a device run in turn on its thread (threads on one device would
    only hand the interpreter lock to each other at every small op).
    seqs: (B, L) with B divisible by the mesh size. Returns worker1_step's
    dict, every key concatenated along reads on ``mesh.devices[0]``."""
    seq_b = _blocks(mesh, seqs, "worker1_sharded")
    len_b = _blocks(mesh, lens, "worker1_sharded")
    didxs = mesh.replicate(didx)
    luts = mesh.replicate(lut) if lut is not None else None
    entries = {}
    for i, d in enumerate(mesh.devices):
        entries.setdefault(d, []).append(i)
    cards = [d for d in entries if d.type == "cuda"]
    callers = {d: torch.cuda.current_stream(d) for d in cards}
    streams = {d: mesh.stream(d) for d in cards}

    def on_device(d: torch.device) -> list:
        return _run_on(d, streams.get(d), lambda: [worker1_step(
            didxs[d], seq_b[i], len_b[i], luts[d] if luts else None,
            scfg=scfg, ccfg=ccfg, ecfg=ecfg) for i in entries[d]],
            callers.get(d))

    with cf.ThreadPoolExecutor(max_workers=len(entries)) as ex:
        done = dict(zip(entries, ex.map(on_device, entries)))
    outs = [None] * mesh.size
    for d, idx in entries.items():
        for i, out in zip(idx, done[d]):
            outs[i] = out
            for t in out.values():
                if t.is_cuda:
                    # read next on this thread's stream for its device
                    t.record_stream(torch.cuda.current_stream(t.device))
    dev0 = mesh.devices[0]
    return {k: torch.cat([o[k].to(dev0) for o in outs]) for k in outs[0]}


def psum(mesh: Mesh, parts: list) -> torch.Tensor:
    """Sum of one partial result per mesh entry, on ``mesh.devices[0]``,
    added in shard order."""
    dev0 = mesh.devices[0]
    out = parts[0].to(dev0)
    for p in parts[1:]:
        out = out + p.to(dev0)
    return out


def insert_size_psum(mesh: Mesh, inserts, valid, max_ins: int):
    """Insert-size histogram over the mesh — the pestat reduction.

    inserts/valid: (B,), B divisible by the mesh size, split along reads;
    each entry bins its block (inserts clipped to 0..max_ins, counting the
    valid ones) on its own device, and the partial histograms are summed.
    Returns the (max_ins+1,) int32 histogram on ``mesh.devices[0]``."""
    parts = []
    for d, ins, ok in zip(mesh.devices,
                          _blocks(mesh, torch.as_tensor(inserts),
                                  "insert_size_psum"),
                          _blocks(mesh, torch.as_tensor(valid),
                                  "insert_size_psum")):
        h = torch.zeros(max_ins + 1, dtype=torch.int32, device=d)
        parts.append(h.index_add_(0, ins.clamp(0, max_ins).to(torch.int64),
                                  ok.to(torch.int32)))
    return psum(mesh, parts)


def pe_hist_psum(dirs, inserts, max_ins: int, device) -> np.ndarray:
    """Orientation-bucketed insert-size histogram — the pestat reduction
    [bwa: mem_pestat's collect step].

    dirs: (P,) int32 in -1..3 (-1 = pair not sampled, not counted; other
    values clipped to 0..3); inserts: (P,) int, clipped to 0..max_ins.
    Host arrays of any length; the scatter-add runs on ``device``. Returns the (4, max_ins+1) int64 histogram
    ready for native mem_pestat_from_hist."""
    with synced(2):     # two uploads from pageable host memory
        d = torch.as_tensor(np.asarray(dirs, np.int32)).to(device)
        ins = torch.as_tensor(np.asarray(inserts, np.int64)).to(device)
    idx = d.clamp(0, 3).to(torch.int64) * (max_ins + 1) + \
        ins.clamp(0, max_ins)
    h = torch.zeros(4 * (max_ins + 1), dtype=torch.int32, device=d.device)
    h.index_add_(0, idx, (d >= 0).to(torch.int32))
    with synced():
        h = h.cpu()
    return h.numpy().astype(np.int64).reshape(4, max_ins + 1)
