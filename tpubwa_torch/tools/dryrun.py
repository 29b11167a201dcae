"""Single step and mesh dry run of tpubwa_torch: the counterpart of
``__graft_entry__.py``.

``entry(device)`` returns ``(fn, args)``: ``fn(*args)`` runs
``dist.mesh.worker1_step`` (seeding, chaining, filtering, banded extension)
on a tiny world and returns ``(score, n)``.

``dryrun_multichip(n_devices, device, out)`` runs worker1 over an
n-entry mesh on the tiny world with the index widened to int64, measures
the efficiency t(1 entry, B) / t(n entries, n*B) (best of 3), checks the
insert-size histogram summed over the mesh and the production pestat
histogram (``pe_hist_psum``) and times the latter, and runs the LOAD test,
1024 reads an entry on a 2 Mbp repeat-rich world (``TPUBWA_DRYRUN_LOAD=0``
leaves it out). It returns a dict with ``SCALING.json``'s keys and writes
it to ``out``, by default ``build/tpubwa_torch/SCALING_torch.json``.

The mesh: with at least n cards in the process, n cards; otherwise n
logical shards on the cards in turn (``Mesh((cuda:0,) * 8)`` on one card).
The entries of one device run in turn on one thread (``dist/mesh.py``), so
on one card ``weak_scaling_naive`` measures running the shards in turn,
not scaling, and ``sharding_overhead_eff`` the cost of the split alone;
the ``note`` key says which kind of mesh the run had.

Usage: python -m tpubwa_torch.tools.dryrun [n_devices] [--platform cuda|cpu]
           [--prepare]
(n_devices defaults to 8). Runs on the card and raises without one unless
``--platform cpu``; prints the card line, entry()'s region counts and the
dry run's summary. ``--prepare`` builds the LOAD test's index and LUT
caches and stops (no card needed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..dist.mesh import (Mesh, insert_size_psum, make_mesh, pe_hist_psum,
                         worker1_sharded, worker1_step)
from ..utils.files import write_atomic
from .scale_bench import card_line, require_card

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / "build" / "tpubwa_torch"
MEDIUM_LEN = 2_000_000
MEDIUM_SEED = 11
PER_DEV = 2             # reads an entry of the tiny world's mesh run
LOAD_PER_DEV = 1024     # reads an entry of the LOAD test
MAX_INS = 1000


def tiny_world(n_reads: int = 16, genome_len: int = 4000, seed: int = 0,
               device="cuda"):
    """A random genome of genome_len bases (rng seed), its index and k-mer
    table on ``device``, n_reads reads of 100 bp at 2% errors (seed 1) and
    the default configs: (didx, lut, batch, (scfg, ccfg, ecfg))."""
    from ..index.builder import build_index
    from ..index.device import DeviceIndex
    from ..io import fastx
    from ..opts import MemOptions
    from ..pipeline import configs_from_opts
    from ..seed.lut import KmerLUT
    from ..utils import dna
    rng = np.random.default_rng(seed)
    genome = dna.decode(rng.integers(0, 4, genome_len).astype(np.uint8))
    idx = build_index([("chr1", genome)])
    recs = fastx.simulate_reads(dna.encode(genome), n_reads, read_len=100,
                                error_rate=0.02, seed=1)
    opt = MemOptions()
    lut = KmerLUT.build(idx, min_seed_len=opt.min_seed_len, device=device)
    return (DeviceIndex.from_host(idx, device), lut, fastx.batch_reads(recs),
            configs_from_opts(opt))


def medium_genome(genome_len: int = MEDIUM_LEN,
                  seed: int = MEDIUM_SEED) -> np.ndarray:
    """The LOAD test's repeat-rich genome (BACTERIAL profile), uint8 codes."""
    from ..utils import genome
    return genome.synthetic_genome(genome_len, seed=seed,
                                   profile=genome.BACTERIAL)


def medium_index(genome_len: int = MEDIUM_LEN, seed: int = MEDIUM_SEED,
                 build_dir: Path = BUILD):
    """The medium genome's FM-index, from its cache or built and cached,
    and its k-mer table's cache file (``dryrun_{index,lut}_<len>.npz``
    under build_dir)."""
    from ..index.builder import FMIndex, build_index
    from ..utils import dna
    build_dir = Path(build_dir)
    cache = build_dir / f"dryrun_index_{genome_len}.npz"
    if cache.exists():
        idx = FMIndex.load(cache)
    else:
        idx = build_index([("dryrun_synth",
                            dna.decode(medium_genome(genome_len, seed)))])
        write_atomic(cache, idx.save)
    return idx, build_dir / f"dryrun_lut_{genome_len}.npz"


def medium_world(n_reads: int = 8192, genome_len: int = MEDIUM_LEN,
                 seed: int = MEDIUM_SEED, device="cuda",
                 build_dir: Path = BUILD):
    """The LOAD test's world: the medium genome's index and k-mer table on
    ``device`` (both cached), n_reads reads of 100 bp at 1% substitutions
    and 0.1% indels (seed 3), configs for its text:
    (didx, lut, batch, (scfg, ccfg, ecfg))."""
    from ..index.device import DeviceIndex
    from ..io import fastx
    from ..opts import MemOptions
    from ..pipeline import configs_from_opts
    from ..seed.lut import KmerLUT
    idx, lut_cache = medium_index(genome_len, seed, build_dir)
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, n_reads, read_len=100, error_rate=0.01,
                                indel_rate=0.001, seed=3)
    opt = MemOptions()
    lut = KmerLUT.build(idx, min_seed_len=opt.min_seed_len, cache=lut_cache,
                        device=device)
    return (DeviceIndex.from_host(idx, device), lut,
            fastx.batch_reads(recs, max_len=100),
            configs_from_opts(opt, text_len=2 * int(idx.l_pac)))


def prepare(build_dir: Path = BUILD) -> None:
    """Build the LOAD test's index and k-mer table caches (host only)."""
    from ..opts import MemOptions
    from ..seed.lut import KmerLUT
    idx, lut_cache = medium_index(build_dir=build_dir)
    KmerLUT.build(idx, min_seed_len=MemOptions().min_seed_len,
                  cache=lut_cache, device="cpu")


def widen(didx, lut=None):
    """(didx, lut) with the index's L2, sa_samples and ann_end and the
    k-mer table's rows in int64, the width a text of 2**31 or more carries.
    The port also runs an int32 table beside a widened index (its rows
    promote where they meet int64 ranks), but a text that long builds its
    table in int64 too, so the table is widened with the index."""
    from ..seed.lut import KmerLUT
    didx = dataclasses.replace(
        didx, L2=didx.L2.to(torch.int64),
        sa_samples=didx.sa_samples.to(torch.int64),
        ann_end=didx.ann_end.to(torch.int64))
    if lut is not None:
        lut = KmerLUT(lut.k0, lut.ksp.to(torch.int64))
    return didx, lut


def entry(device="cuda"):
    """(fn, args): fn(*args) is the full worker1 step on the tiny world
    (16 reads), returning (score, n)."""
    require_card(device, "dryrun")
    didx, lut, batch, (scfg, ccfg, ecfg) = tiny_world(device=device)
    seqs = torch.as_tensor(batch.seqs.astype(np.int32)).to(device)
    lens = torch.as_tensor(batch.lens).to(device)

    def fn(didx, lut, seqs, lens):
        out = worker1_step(didx, seqs, lens, lut, scfg=scfg, ccfg=ccfg,
                           ecfg=ecfg)
        return out["score"], out["n"]

    return fn, (didx, lut, seqs, lens)


def dry_mesh(n_devices: int, device="cuda") -> tuple:
    """(mesh, note): n cards when the process has that many, else n
    logical shards on the cards in turn; n shards on the host for the
    CPU."""
    if torch.device(device).type == "cpu":
        return make_mesh(n_devices, device="cpu"), (
            f"{n_devices} shards on the host CPU (the plain PyTorch path), "
            "run in turn on one thread: the numbers check the method and "
            "the code path only.")
    k = torch.cuda.device_count()
    if k >= n_devices:
        return make_mesh(n_devices), (
            f"{n_devices} cards ({card_line(device)}), a thread and a "
            "stream each: scaling_efficiency and "
            "load_test.weak_scaling_naive are weak scaling; "
            "load_test.sharding_overhead_eff compares the same total work "
            "over the mesh and on one card.")
    mesh = Mesh(tuple(torch.device("cuda", i % k) for i in range(n_devices)))
    return mesh, (
        f"{n_devices} logical shards on {k} card(s) ({card_line(device)}), "
        "the shards of a card run in turn on one thread: "
        "scaling_efficiency and load_test.weak_scaling_naive measure "
        "running the shards in turn, not scaling; "
        "load_test.sharding_overhead_eff is the cost of the split alone "
        "(the same total work, sharded against unsharded).")


def sync(mesh: Mesh) -> None:
    """Wait for every card of the mesh."""
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_multichip(n_devices: int, device="cuda", out=None) -> dict:
    """worker1 over an n-entry mesh on the int64-widened tiny world, the
    scaling measurement, the histogram reductions and the LOAD test; the
    SCALING.json-shaped dict, also written to ``out``."""
    require_card(device, "dryrun")
    mesh, note = dry_mesh(n_devices, device)
    dev0 = mesh.devices[0]
    mesh1 = Mesh((dev0,))
    didx, lut, batch, (scfg, ccfg, ecfg) = tiny_world(
        n_reads=PER_DEV * n_devices, device=dev0)
    # positions and ranks in int64, the dtype of a >1 Gbp index, so the
    # dry run goes through the large-genome path
    didx, lut = widen(didx, lut)
    seqs = torch.as_tensor(batch.seqs.astype(np.int32)).to(dev0)
    lens = torch.as_tensor(batch.lens).to(dev0)
    res = worker1_sharded(mesh, didx, seqs, lens, scfg, ccfg, ecfg, lut)
    sync(mesh)
    n = res["n"].cpu().numpy()
    if n.shape != (PER_DEV * n_devices,) or not (n >= 1).all():
        raise AssertionError(f"dryrun: region counts {n}")

    def timed(fn, reps=3):
        fn()
        sync(mesh)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync(mesh)
            best = min(best, time.perf_counter() - t0)
        return best

    # per-entry batch held constant: t(1 entry, B) / t(n entries, n*B)
    seqs1, lens1 = seqs[:PER_DEV], lens[:PER_DEV]
    t_1 = timed(lambda: worker1_sharded(mesh1, didx, seqs1, lens1,
                                        scfg, ccfg, ecfg, lut))
    t_n = timed(lambda: worker1_sharded(mesh, didx, seqs, lens,
                                        scfg, ccfg, ecfg, lut))
    eff = t_1 / t_n if t_n > 0 else 0.0

    # the insert-size histogram summed over the mesh
    inserts = torch.as_tensor(np.random.default_rng(0).integers(
        100, 500, PER_DEV * n_devices), dtype=torch.int32).to(dev0)
    ok = torch.ones(PER_DEV * n_devices, dtype=torch.bool, device=dev0)
    hist = insert_size_psum(mesh, inserts, ok, max_ins=MAX_INS)
    if int(hist.sum()) != PER_DEV * n_devices:
        raise AssertionError(f"dryrun: insert_size_psum counted "
                             f"{int(hist.sum())} of {PER_DEV * n_devices}")
    # the production pestat histogram (orientation-bucketed, the one
    # align_pe feeds to mem_pestat_from_hist) and its cost a batch
    rng = np.random.default_rng(1)
    dirs = rng.integers(-1, 4, 4 * n_devices).astype(np.int32)
    isz = rng.integers(1, 900, 4 * n_devices).astype(np.int64)
    hist4 = pe_hist_psum(dirs, isz, MAX_INS, dev0)
    if hist4.shape != (4, MAX_INS + 1) or \
            hist4.sum() != int((dirs >= 0).sum()):
        raise AssertionError(f"dryrun: pe_hist_psum gave {hist4.shape}, "
                             f"total {hist4.sum()}")
    t_coll = timed(lambda: pe_hist_psum(dirs, isz, MAX_INS, dev0))

    # the LOAD test at a production batch shape on a repeat-rich world:
    # naive weak scaling t(1, B) / t(n, n*B) and the sharding overhead
    # t(1, n*B) / t(n, n*B), the same total work with and without the split
    load = {}
    if os.environ.get("TPUBWA_DRYRUN_LOAD", "1") != "0":
        nb = LOAD_PER_DEV * n_devices
        mdidx, mlut, mbatch, (mscfg, mccfg, mecfg) = medium_world(
            n_reads=nb, device=dev0)
        mseqs = torch.as_tensor(mbatch.seqs.astype(np.int32)).to(dev0)
        mlens = torch.as_tensor(mbatch.lens).to(dev0)
        t1_B = timed(lambda: worker1_sharded(
            mesh1, mdidx, mseqs[:LOAD_PER_DEV], mlens[:LOAD_PER_DEV],
            mscfg, mccfg, mecfg, mlut), reps=1)
        t1_NB = timed(lambda: worker1_sharded(
            mesh1, mdidx, mseqs, mlens, mscfg, mccfg, mecfg, mlut), reps=1)
        tN_NB = timed(lambda: worker1_sharded(
            mesh, mdidx, mseqs, mlens, mscfg, mccfg, mecfg, mlut), reps=1)
        rngl = np.random.default_rng(2)
        dirs_l = rngl.integers(-1, 4, nb // 2).astype(np.int32)
        isz_l = rngl.integers(1, 900, nb // 2).astype(np.int64)
        t_coll_l = timed(lambda: pe_hist_psum(dirs_l, isz_l, MAX_INS, dev0),
                         reps=1)
        load = {
            "per_device_reads": LOAD_PER_DEV,
            "genome_len": MEDIUM_LEN,
            "t_1dev_perdev_batch_s": round(t1_B, 3),
            "t_1dev_full_batch_s": round(t1_NB, 3),
            "t_ndev_full_batch_s": round(tN_NB, 3),
            "weak_scaling_naive": round(t1_B / max(tN_NB, 1e-9), 3),
            "sharding_overhead_eff": round(t1_NB / max(tN_NB, 1e-9), 3),
            "pestat_collective_s": round(t_coll_l, 4),
            "collective_share_pct": round(
                100 * t_coll_l / max(tN_NB, 1e-9), 2),
            "host_cores": os.cpu_count(),
        }
        print(f"[dryrun] load: {LOAD_PER_DEV} reads an entry, "
              f"t1(B)={t1_B:.3f}s t1(NB)={t1_NB:.3f}s tN(NB)={tN_NB:.3f}s "
              f"shard_overhead_eff={load['sharding_overhead_eff']:.3f} "
              f"(naive weak={load['weak_scaling_naive']:.3f})", flush=True)

    scaling = {
        "n_devices": n_devices,
        "per_device_reads": PER_DEV,
        "t_1dev_s": round(t_1, 4),
        "t_ndev_s": round(t_n, 4),
        "scaling_efficiency": round(eff, 3),
        "pestat_collective_s": round(t_coll, 4),
        "collective_share_pct": round(100 * t_coll / max(t_n, 1e-9), 1),
        "index_pos_dtype": str(didx.pos_dtype).replace("torch.", ""),
        "load_test": load,
        "note": note,
    }
    out = Path(out) if out is not None else BUILD / "SCALING_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(scaling, indent=1) + "\n")
    print(f"[dryrun] ok on {n_devices} entries: {int(n.sum())} regions, "
          f"histogram total {int(hist.sum())}, pe_hist4 total "
          f"{int(hist4.sum())}; t_1dev={t_1:.4f}s t_{n_devices}dev="
          f"{t_n:.4f}s eff={eff:.3f} pestat_collective="
          f"{t_coll * 1e3:.2f}ms -> {out}", flush=True)
    return scaling


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.dryrun",
        description="worker1 on a tiny world, then the mesh dry run")
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--prepare", action="store_true",
                    help="build the LOAD test's index and LUT caches and "
                         "stop (no card needed)")
    a = ap.parse_args(argv)
    if a.prepare:
        t0 = time.time()
        prepare()
        print(json.dumps({"prepared": f"dryrun_{MEDIUM_LEN}",
                          "seconds": round(time.time() - t0, 1)}))
        return 0
    require_card(a.platform, "dryrun")
    print(f"card: {card_line(a.platform)}", flush=True)
    fn, args = entry(a.platform)
    print("entry():", fn(*args)[1].tolist(), flush=True)
    dryrun_multichip(a.n_devices, a.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
