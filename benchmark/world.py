"""A cell's world: its configuration and traffic mix (found by name), the
genome, the aligner's index and k-mer table, and the reads. The genome's
generator (``genomes/<name>.py``) and the reads' (``reads/<name>.py``) are
found by the names the configuration and the traffic file give.

What is slow to make and the same on every run is cached under
``benchmark/cache/`` at a fixed path, written whole or not at all (a
temporary file beside the target, then a rename), and keyed by what made
it: the configuration's genome fields and the source of the code that
built it. A change to the index builder, the k-mer table or the generator
therefore builds anew on the next run instead of loading a stale file.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
CACHE = ROOT / "cache"

# program sources whose change rebuilds the program's cached index / LUT
INDEX_SOURCES = ("tpubwa_torch/index/builder.py", "native/sais.cpp",
                 "tpubwa_torch/utils/dna.py")
LUT_SOURCES = ("tpubwa_torch/seed/lut.py",)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict


def find_cell(bench: dict, workload: str, root: Path = REPO,
              traffic_dir: Path = ROOT / "traffic") -> Cell:
    """The cell named in the benchmark, its configuration file (the
    config's ``file``) and its traffic file (``traffic/<name>.json``)."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(w['name'] for w in bench['workloads'])}")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(root / cfg["file"])
    traffic = load_json(Path(traffic_dir) / f"{wl['traffic']}.json")
    return Cell(wl, config, traffic)


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def source_digest(paths, root: Path = REPO) -> str:
    return digest(*((root / p).read_bytes() if (root / p).exists() else p
                    for p in paths))


def write_atomic(path: Path, write) -> Path:
    """``write(tmp)`` to a temporary file beside path, then rename it over
    path; the temporary file keeps path's suffix (``np.savez`` and
    ``np.save`` add none to a name that has it)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=path.suffix, dir=path.parent)
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def genome_key(config: dict) -> str:
    fields = {k: config[k] for k in ("contig", "genome_len", "genome_seed",
                                     "genome")}
    src = ROOT / "genomes" / f"{config['genome']['generator']}.py"
    return digest(json.dumps(fields, sort_keys=True), src.read_bytes())


def genome(config: dict, cache: Path = CACHE, built: list | None = None
           ) -> np.ndarray:
    """The configuration's genome (codes 0..4), from the cache or made;
    ``built`` gets "genome" where it was made."""
    path = cache / f"genome_{config['name']}_{genome_key(config)}.npy"
    if path.exists():
        return np.load(path)
    mod = importlib.import_module(
        f"{__package__}.genomes.{config['genome']['generator']}")
    g = mod.make(config)
    write_atomic(path, lambda tmp: np.save(tmp, g))
    if built is not None:
        built.append("genome")
    return g


def mem_options(config: dict):
    """The program's options for the configuration."""
    from tpubwa_torch.opts import MemOptions
    opts = {k: v for k, v in config["options"].items() if k != "cli"}
    return MemOptions(**opts)


def program_index(config: dict, g: np.ndarray, cache: Path = CACHE,
                  root: Path = REPO, built: list | None = None):
    """The program's FM-index of the genome, built by its own builder (the
    port's ``bwa index``) on a checkout's first run, loaded after."""
    from tpubwa_torch.index.builder import FMIndex, build_index
    from tpubwa_torch.utils import dna
    key = digest(genome_key(config), config["amb_seed"],
                 source_digest(INDEX_SOURCES, root))
    path = cache / f"index_{config['name']}_{key}.npz"
    if path.exists():
        return FMIndex.load(path), key
    idx = build_index([(config["contig"], dna.decode(g))],
                      amb_seed=int(config["amb_seed"]))
    write_atomic(path, idx.save)
    if built is not None:
        built.append("index")
    return idx, key


def lut_path(config: dict, index_key: str, cache: Path = CACHE,
             root: Path = REPO) -> Path:
    key = digest(index_key, source_digest(LUT_SOURCES, root),
                 config["options"]["min_seed_len"])
    return cache / f"lut_{config['name']}_{key}.npz"


@dataclasses.dataclass
class Batch:
    """One batch of records as the benchmark made them: codes (n, L) padded
    with 4, lengths, names; no qualities (SAM's '*')."""
    seqs: np.ndarray
    lens: np.ndarray
    names: list

    @property
    def n(self) -> int:
        return len(self.names)


def make_batch(traffic: dict, g: np.ndarray, seed: int, index: int) -> Batch:
    """Batch ``index`` of a run seeded ``seed`` (index -1: the warm-up),
    made by the traffic's generator."""
    mod = importlib.import_module(
        f"{__package__}.reads.{traffic['generator']}")
    return mod.make_batch(traffic, g, seed, index)
