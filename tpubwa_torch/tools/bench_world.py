"""The 4.6 Mbp bench world (BASELINE config 1): the genome, its FM-index and
k-mer table, and the SE 100 bp reads that ``bench.py`` aligns, for the
port's tools and ``chip_smoke.py``.

The genome is ``utils.genome.synthetic_genome(4_600_000, seed=2024)`` with
the BACTERIAL repeat profile; its index and LUT are cached as
``build/tpubwa_torch/smoke_{index,lut}_4600000.npz``, each written to a
temporary file and renamed into place (a process killed mid-write leaves
no truncated cache behind). Reads: 100 bp, 1%
substitutions, 0.1% indels, seed 7.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / "build" / "tpubwa_torch"
GENOME_LEN = 4_600_000
GENOME_SEED = 2024
READ_LEN = 100
BATCH = 4096
ERROR_RATE = 0.01
INDEL_RATE = 0.001
READS_SEED = 7


def get_index(build_dir: Path = BUILD, genome_len: int = GENOME_LEN):
    """The bench genome's FM-index, from its cache or built and cached."""
    from ..index.builder import FMIndex, build_index
    from ..utils import dna, genome
    from ..utils.files import write_atomic
    cache = Path(build_dir) / f"smoke_index_{genome_len}.npz"
    if cache.exists():
        return FMIndex.load(cache)
    g = genome.synthetic_genome(genome_len, seed=GENOME_SEED,
                                profile=genome.BACTERIAL)
    idx = build_index([("U00096_synth", dna.decode(g))])
    write_atomic(cache, idx.save)
    return idx


def lut_path(build_dir: Path = BUILD, genome_len: int = GENOME_LEN) -> Path:
    return Path(build_dir) / f"smoke_lut_{genome_len}.npz"


def prepare(build_dir: Path = BUILD, genome_len: int = GENOME_LEN) -> None:
    """Build the index and LUT caches on the host (no card needed), so
    that a later make_aligner only loads them."""
    from ..opts import MemOptions
    from ..seed.lut import KmerLUT
    KmerLUT.build(get_index(build_dir, genome_len),
                  min_seed_len=MemOptions().min_seed_len,
                  cache=lut_path(build_dir, genome_len), device="cpu")


def make_aligner(device: str = "cuda", build_dir: Path = BUILD,
                 genome_len: int = GENOME_LEN, **caps):
    """The bench aligner on ``device`` (the card unless the caller asks
    for the CPU), its LUT from the cache; ``caps`` as ``Aligner``'s."""
    from ..opts import MemOptions
    from ..pipeline import Aligner
    return Aligner(get_index(build_dir, genome_len), MemOptions(),
                   device=device, lut_cache=lut_path(build_dir, genome_len),
                   **caps)


def reads(idx, n: int = BATCH, seed: int = READS_SEED):
    """n bench reads from the index's forward strand, as one ReadBatch."""
    from ..io import fastx
    fwd = idx.get_seq(0, idx.l_pac).astype(np.uint8)
    recs = fastx.simulate_reads(fwd, n, read_len=READ_LEN,
                                error_rate=ERROR_RATE,
                                indel_rate=INDEL_RATE, seed=seed)
    return fastx.batch_reads(recs, max_len=READ_LEN)
