"""Genome-scale check of the port (BASELINE configs 3 and 4): alignment
against a repeat-rich synthetic genome through the production path, with
every timed SAM line held to the scalar oracle's, byte for byte.

The genome is ``utils.genome.synthetic_genome(genome_mbp * 10**6, seed=7)``
with the HUMAN repeat profile from 32 Mbp up and the BACTERIAL one below;
its FM-index comes from ``index.builder.build_index`` (the native SA-IS)
and its k-mer table from ``KmerLUT.build``. All three are cached under
``build/tpubwa_torch/scale_{genome,index,lut}_hard_<glen>.*``. Reads: SE
100 bp, 1% substitutions, 0.1% indels, seed 3, in batches of 4096; the
first batch is aligned once to warm up, then every batch is timed through
``align_se_stream``. ``--pe`` adds a row of 150 bp pairs (inserts
400 +- 50, seed 5): one warm-up batch of 1024 pairs and one timed batch,
SAM byte-equal to ``Oracle.align_pe`` and no rescue result missing.

Prints one JSON line for SE (and one for PE) to standard output; progress
goes to standard error.

Usage: python -m tpubwa_torch.tools.scale_bench [n_reads] [genome_mbp]
           [--pe] [--prepare] [--platform cuda|cpu]
  e.g.  python -m tpubwa_torch.tools.scale_bench 8192 64     # chr20 size
``--prepare`` builds the caches and stops (no card needed). The run needs
a CUDA card and raises without one; ``--platform cpu`` runs the plain
PyTorch path on the host, for tests at a tiny size.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ..utils.files import write_atomic

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / "build" / "tpubwa_torch"
GENOME_SEED = 7
HUMAN_PROFILE_MIN_MBP = 32
BATCH = 4096
READ_LEN = 100
PE_PAIRS = 1024
PE_READ_LEN = 150


def log(msg: str) -> None:
    print(f"scale_bench: {msg}", file=sys.stderr, flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def default_profile(mbp: float) -> str:
    return "human" if mbp >= HUMAN_PROFILE_MIN_MBP else "bacterial"


def cache_paths(glen: int, profile: str, build_dir: Path = BUILD):
    """(index, genome, LUT) cache files of a genome of glen bases. A
    profile other than the size's own is named in the genome's and the
    index's file names, so the two never share a file."""
    tag = "hard" if profile == default_profile(glen / 1e6) else \
        f"hard_{profile}"
    build_dir = Path(build_dir)
    return (build_dir / f"scale_index_{tag}_{glen}.npz",
            build_dir / f"scale_genome_{tag}_{glen}.npy",
            build_dir / f"scale_lut_{tag}_{glen}.npz")


def get_genome(mbp: float, costs: dict, profile: str | None = None,
               build_dir: Path = BUILD) -> np.ndarray:
    """Load or build and cache the genome: uint8 codes (4 = N), mapped
    read-only from the cache."""
    from ..utils import genome
    glen = int(round(mbp * 1_000_000))
    profile = profile or default_profile(mbp)
    _, path, _ = cache_paths(glen, profile, build_dir)
    t0 = time.time()
    if not path.exists():
        g = genome.synthetic_genome(glen, seed=GENOME_SEED, profile={
            "human": genome.HUMAN, "bacterial": genome.BACTERIAL}[profile])
        write_atomic(path, lambda tmp: np.save(tmp, g))
        costs["genome_build_s"] = round(time.time() - t0, 1)
    else:
        costs["genome_load_s"] = round(time.time() - t0, 1)
    return np.load(path, mmap_mode="r")


def get_index(mbp: float, g: np.ndarray, costs: dict,
              profile: str | None = None, build_dir: Path = BUILD):
    """Load or build (native SA-IS) and cache the genome's FM-index."""
    from ..index.builder import FMIndex, build_index
    glen = int(round(mbp * 1_000_000))
    path, _, _ = cache_paths(glen, profile or default_profile(mbp),
                             build_dir)
    t0 = time.time()
    if path.exists():
        idx = FMIndex.load(path)
        costs["index_load_s"] = round(time.time() - t0, 1)
        return idx
    idx = build_index([("scale_synth", np.asarray(g))])
    costs["index_build_s"] = round(time.time() - t0, 1)
    costs["index_build_rss_gb"] = round(rss_gb(), 1)
    t0 = time.time()
    write_atomic(path, idx.save)
    costs["index_save_s"] = round(time.time() - t0, 1)
    return idx


def lut_path(mbp: float, profile: str | None = None,
             build_dir: Path = BUILD) -> Path:
    glen = int(round(mbp * 1_000_000))
    return cache_paths(glen, profile or default_profile(mbp), build_dir)[2]


def prepare(mbp: float, costs: dict, profile: str | None = None,
            build_dir: Path = BUILD):
    """Genome, index and k-mer table, each from its cache or built and
    cached; returns (genome, index)."""
    from ..opts import MemOptions
    from ..seed.lut import KmerLUT
    g = get_genome(mbp, costs, profile, build_dir)
    idx = get_index(mbp, g, costs, profile, build_dir)
    path = lut_path(mbp, profile, build_dir)
    t0 = time.time()
    built = not path.exists()
    KmerLUT.build(idx, min_seed_len=MemOptions().min_seed_len, cache=path,
                  device="cpu")
    costs["lut_build_s" if built else "lut_load_s"] = \
        round(time.time() - t0, 1)
    return g, idx


def load_cached(mbp: float, costs: dict, profile: str | None = None,
                build_dir: Path = BUILD):
    """(genome, index) of a prepared world; raises FileNotFoundError,
    naming the command that prepares it, when a cache file is missing."""
    glen = int(round(mbp * 1_000_000))
    for path in cache_paths(glen, profile or default_profile(mbp),
                            build_dir):
        if not path.exists():
            raise FileNotFoundError(
                f"{path} is missing: prepare the {mbp:g} Mbp world with "
                f"python -m tpubwa_torch.tools.scale_bench {BATCH} {mbp:g} "
                "--prepare")
    g = get_genome(mbp, costs, profile, build_dir)
    return g, get_index(mbp, g, costs, profile, build_dir)


def make_aligner(idx, mbp: float, costs: dict, device: str = "cuda",
                 profile: str | None = None, build_dir: Path = BUILD):
    """The aligner on ``device``, its k-mer table from the cache; records
    the set-up time and the device bytes of the index and the table."""
    from ..opts import MemOptions
    from ..pipeline import Aligner
    t0 = time.time()
    aln = Aligner(idx, MemOptions(), device=device,
                  lut_cache=lut_path(mbp, profile, build_dir))
    costs["aligner_init_s"] = round(time.time() - t0, 1)
    return aln


def device_bytes(aln) -> dict:
    import torch
    d = aln.didx
    index = sum(getattr(d, f).numel() * getattr(d, f).element_size()
                for f in vars(d) if isinstance(getattr(d, f), torch.Tensor))
    lut = aln.lut.ksp.numel() * aln.lut.ksp.element_size()
    return {"index": index, "lut": lut}


def require_card(device: str, prog: str) -> None:
    """Raise unless ``device`` is the CPU or a CUDA card is present."""
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"{prog}: no CUDA device is available; "
                               "pass --platform cpu to run on the host")


def card_line(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or "cpu"."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def se_batch(g, n_reads: int, seed: int = 3):
    """n_reads SE 100 bp reads of the genome (1% substitutions, 0.1%
    indels) as one ReadBatch."""
    from ..io import fastx
    recs = fastx.simulate_reads(np.asarray(g), n_reads, read_len=READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=seed)
    return fastx.batch_reads(recs, max_len=READ_LEN)


def sync(aln) -> None:
    """Wait for the aligner's card (a CPU aligner has nothing queued)."""
    if aln.device.type == "cuda":
        import torch
        torch.cuda.synchronize(aln.device)


def oracle_se(aln, batches, id0s) -> list:
    """The oracle's SAM of each batch: chunk t of every batch on thread t
    with native handle t (a read's lines depend on its own id only)."""
    from ..pipeline import _slice_batch
    k = aln._n_finish_threads()
    oracles = aln._finish_oracles(k)

    def chunks(t):
        out = []
        for b, i0 in zip(batches, id0s):
            lo, hi = round(b.n * t / k), round(b.n * (t + 1) / k)
            out.append(oracles[t].align_se(_slice_batch(b, lo, hi), aln.opt,
                                           id0=i0 + lo, rg_id=aln.rg_id))
        return out
    with cf.ThreadPoolExecutor(k) as ex:
        parts = list(ex.map(chunks, range(k)))
    return ["".join(parts[t][i] for t in range(k))
            for i in range(len(batches))]


def count_mismatches(got: str, want: str) -> tuple:
    """(lines checked, lines that differ): the oracle's lines, each against
    the line at its place in got; extra lines in got count as differing."""
    g, w = got.splitlines(True), want.splitlines(True)
    bad = sum(i >= len(g) or g[i] != line for i, line in enumerate(w))
    return len(w), bad + max(0, len(g) - len(w))


def se_row(aln, g, n_reads: int, mbp: float, costs: dict,
           batch: int = BATCH):
    """SE 100 bp: one warm-up batch, then every batch streamed and timed,
    every line held to the oracle. Returns the JSON row and the read
    batches."""
    from ..io import fastx
    from ..ops import sw
    recs = fastx.simulate_reads(np.asarray(g), n_reads, read_len=READ_LEN,
                                error_rate=0.01, indel_rate=0.001, seed=3)
    batches = [fastx.batch_reads(recs[i:i + batch], max_len=READ_LEN)
               for i in range(0, n_reads, batch)]
    t0 = time.time()
    aln.align_se(batches[0], id0=0)
    costs["warmup_s"] = round(time.time() - t0, 1)
    aln.stats = {"reads": 0, "fallback_reads": 0}
    sw.ksw_extend.launches = 0
    sync(aln)
    t1 = time.time()
    sams = []
    for sam in aln.align_se_stream(batches, id0=0):
        sams.append(sam)
        log(f"batch {len(sams)} of {len(batches)} done at "
            f"{time.time() - t1:.1f} s")
    sync(aln)
    dt = time.time() - t1
    k1 = sw.ksw_extend.launches
    t0 = time.time()
    id0s = list(range(0, n_reads, batch))
    want = oracle_se(aln, batches, id0s)
    checked, mism = count_mismatches("".join(sams), "".join(want))
    costs["parity_s"] = round(time.time() - t0, 1)
    st = aln.stats
    return {
        "metric": f"se_100bpreads_per_s_{mbp:g}mbp_repeatrich",
        "value": round(n_reads / dt, 1),
        "unit": "reads/s",
        "genome_mbp": mbp,
        "pos_dtype": str(aln.didx.pos_dtype).replace("torch.", ""),
        "parity_lines_checked": checked,
        "parity_mismatches": mism,
        "fallback_pct": round(100.0 * st["fallback_reads"]
                              / max(st["reads"], 1), 2),
        "peak_rss_gb": round(rss_gb(), 1),
        "costs": costs,
        "tier1_ovf": st.get("tier1_ovf", 0),
        "tier2_rows": st.get("tier2_rows", 0),
        "tier3_rows": st.get("tier3_rows", 0),
        "tier_batches": st.get("tier_batches", []),
        "k1_launches": k1,
        "seconds": round(dt, 3),
        "device": aln.device.type,
        "device_bytes": device_bytes(aln),
    }, batches


def pe_row(aln, g, mbp: float, pairs: int = PE_PAIRS) -> dict:
    """PE 150 bp: one warm-up batch of ``pairs`` pairs, one timed batch,
    SAM byte-equal to Oracle.align_pe with no rescue result missing."""
    from ..io import fastx
    from ..ops import sw, sw_local
    recs = fastx.simulate_reads(
        np.asarray(g), 2 * pairs, read_len=PE_READ_LEN, paired=True,
        error_rate=0.01, indel_rate=0.001, seed=5, insert_mean=400,
        insert_std=50)
    pb = [fastx.batch_reads(recs[i:i + 2 * pairs], max_len=PE_READ_LEN)
          for i in range(0, len(recs), 2 * pairs)]
    t0 = time.time()
    aln.align_pe(pb[0], id0=0)
    warm = round(time.time() - t0, 1)
    aln.stats = {"reads": 0, "fallback_reads": 0}
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    sw.ksw_extend.launches = sw_local.ksw_local.launches = 0
    sync(aln)
    t0 = time.time()
    out = aln.align_pe(pb[1], id0=pairs)
    sync(aln)
    dt = time.time() - t0
    misses = lib.tb_rescue_miss_count()
    k1, k2 = sw.ksw_extend.launches, sw_local.ksw_local.launches
    checked, mism = count_mismatches(
        out, aln.oracle.align_pe(pb[1], aln.opt, id0=pairs)[0])
    st = aln.stats
    return {
        "metric": f"pe_150bpreads_per_s_{mbp:g}mbp_repeatrich",
        "value": round(pb[1].n / dt, 1),
        "unit": "reads/s",
        "genome_mbp": mbp,
        "pe_fallback_pct": round(100.0 * st["fallback_reads"]
                                 / max(st["reads"], 1), 2),
        "pe_compile_s": warm,
        "parity_lines_checked": checked,
        "parity_mismatches": mism,
        "rescue_results_missing": misses,
        "rescue_tasks": st.get("rescue_tasks", 0),
        "tier1_ovf": st.get("tier1_ovf", 0),
        "tier2_rows": st.get("tier2_rows", 0),
        "tier3_rows": st.get("tier3_rows", 0),
        "k1_launches": k1,
        "k2_launches": k2,
        "seconds": round(dt, 3),
    }


def run(n_reads: int = 8192, mbp: float = 64, pe: bool = False,
        device: str = "cuda", profile: str | None = None,
        build_dir: Path = BUILD, pe_pairs: int = PE_PAIRS) -> list:
    """The SE row (and the PE row); each a dict of the JSON line's keys."""
    require_card(device, "scale_bench")
    costs = {}
    g, idx = prepare(mbp, costs, profile, build_dir)
    aln = make_aligner(idx, mbp, costs, device, profile, build_dir)
    rows = [se_row(aln, g, n_reads, mbp, costs)[0]]
    if pe:
        rows.append(pe_row(aln, g, mbp, pe_pairs))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpubwa_torch.tools.scale_bench",
        description="genome-scale alignment check with oracle SAM parity")
    ap.add_argument("n_reads", nargs="?", type=int, default=8192)
    ap.add_argument("genome_mbp", nargs="?", type=float, default=64)
    ap.add_argument("--pe", action="store_true",
                    help="add the paired-end row (1024 pairs of 150 bp)")
    ap.add_argument("--prepare", action="store_true",
                    help="build the genome, index and LUT caches and stop")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if a.prepare:
        costs = {}
        prepare(a.genome_mbp, costs)
        print(json.dumps({"prepared_mbp": a.genome_mbp, "costs": costs}))
        return 0
    for row in run(a.n_reads, a.genome_mbp, a.pe, a.platform):
        print(json.dumps(row), flush=True)
        bad = row["parity_mismatches"] or row.get("rescue_results_missing")
        if bad:
            log(f"{row['metric']}: {row['parity_mismatches']} SAM lines "
                f"differ from the oracle, "
                f"{row.get('rescue_results_missing', 0)} rescue results "
                "missing")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
