"""Whether what the timed path produced is correct.

Batches drawn from the run's seed among those the window aligned are
aligned again by the plain reference (``refbwa``), which builds its own
index from the genome, and every SAM record is compared byte for byte with
the program's. The numbers compared, each with its limit:

* ``sam_lines_differing``: reference records that the program's output
  does not hold at the same place, plus the difference in record counts
  (limit 0: the configuration guarantees identical SAM).

The reference runs in worker processes (spawned, NumPy only), over the
reads of a batch for the regions and over its pairs for the pairing.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from pathlib import Path

import numpy as np

from . import world
from .refbwa import fm, mem, pe

CHUNK = 64
# the control: the reference with one of the guaranteed semantics broken,
# bwa's re-seeding of long, rare SMEMs from their middle left out (a
# second seeding round a later change might be tempted to skip)
CONTROL = {"split_width": 0}


def opt_of(config: dict, **override) -> mem.Opt:
    kw = {k: v for k, v in config["options"].items() if k != "cli"}
    kw.update(override)
    return mem.Opt(**kw)


def ref_dir(config: dict, cache: Path = world.CACHE) -> Path:
    key = world.digest(world.genome_key(config), config["amb_seed"],
                       (world.ROOT / "refbwa" / "fm.py").read_bytes())
    return cache / f"ref_{config['name']}_{key}"


def ensure_ref_index(config: dict, g: np.ndarray,
                     cache: Path = world.CACHE) -> Path:
    """The reference's own index of the genome: built once a checkout (a
    suffix array by prefix doubling), then loaded from its files."""
    d = ref_dir(config, cache)
    if (d / "occ.npy").exists():
        return d
    fwd = fm.substitute_ambiguous(g, int(config["amb_seed"]))
    text, sa, occ = fm.RefIndex.arrays(fwd)
    d.mkdir(parents=True, exist_ok=True)
    for name, arr in (("text", text), ("sa", sa), ("occ", occ)):
        world.write_atomic(d / f"{name}.npy", lambda tmp, a=arr: np.save(tmp, a))
    return d


def load_ref_index(config: dict, d: Path) -> fm.RefIndex:
    arr = {k: np.load(d / f"{k}.npy", mmap_mode="r")
           for k in ("text", "sa", "occ")}
    return fm.RefIndex(arr["text"], arr["sa"], arr["occ"], [config["contig"]],
                       [0], [int(config["genome_len"])])


# ---- worker side ----
_W: dict = {}


def _init(config: dict, d: str, opt_kw: dict):
    _W["idx"] = load_ref_index(config, Path(d))
    _W["opt"] = opt_of(config, **opt_kw)
    _W["names"] = [config["contig"]]


def _se_chunk(items):
    idx, opt, names = _W["idx"], _W["opt"], _W["names"]
    return [mem.align_se(opt, idx, names, name, q, None, rid)
            for name, q, rid in items]


def _regs_chunk(qs):
    idx, opt = _W["idx"], _W["opt"]
    return [mem.mem_align1(opt, idx, q) for q in qs]


def _pe_chunk(args):
    pes, items = args
    idx, opt, names = _W["idx"], _W["opt"], _W["names"]
    out = []
    for pid, nm, seqs, regs in items:
        out.extend(pe.sam_pe(opt, idx, names, pes, pid, nm, seqs,
                             [None, None], regs))
    return out


def _chunks(xs, k=CHUNK):
    return [xs[i:i + k] for i in range(0, len(xs), k)]


class Reference:
    """The reference's workers over one configuration's index."""

    def __init__(self, config: dict, d: Path, procs: int, **opt_override):
        self.config = config
        self.procs = max(1, procs)
        self.pool = mp.get_context("spawn").Pool(
            self.procs, initializer=_init,
            initargs=(config, str(d), opt_override))
        self.l_pac = int(config["genome_len"])
        self.opt = opt_of(config, **opt_override)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # every map() has returned: no task is left for the workers
        self.pool.terminate()
        self.pool.join()

    def sam(self, batch: world.Batch, id0: int, paired: bool) -> str:
        """The SAM records of a batch whose first read (or pair) is
        numbered id0 in its run."""
        qs = [batch.seqs[i, :batch.lens[i]].tolist() for i in range(batch.n)]
        if not paired:
            items = [(batch.names[i], qs[i], id0 + i) for i in range(batch.n)]
            parts = self.pool.map(_se_chunk, _chunks(items))
            return "".join(s for p in parts for s in p)
        regs = [r for p in self.pool.map(_regs_chunk, _chunks(qs)) for r in p]
        pes = pe.pestat(self.opt, self.l_pac, regs)
        items = [(id0 + p, [batch.names[2 * p], batch.names[2 * p + 1]],
                  [qs[2 * p], qs[2 * p + 1]], [regs[2 * p], regs[2 * p + 1]])
                 for p in range(batch.n // 2)]
        parts = self.pool.map(_pe_chunk,
                              [(pes, c) for c in _chunks(items, CHUNK // 2)])
        return "".join(s for p in parts for s in p)


def lines_differing(got: str, want: str) -> int:
    """Reference records not matched at their place in the program's
    output, plus the difference in record counts."""
    g, w = got.splitlines(), want.splitlines()
    return sum(1 for x, y in zip(g, w) if x != y) + abs(len(g) - len(w))


def default_procs() -> int:
    return max(1, min(7, (os.cpu_count() or 2) - 1))
