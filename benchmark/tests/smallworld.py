"""A small world for the CPU tests: a 300 kbp configuration and traffic
mixes cut to batches of a few hundred records, under a benchmark file of
their own, with caches in a temporary directory."""
import json
from pathlib import Path

from benchmark import world


def make(tmp: Path, batch_records: int = 128) -> dict:
    """Writes the small world under tmp; returns the benchmark dict."""
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    cfg = world.load_json(world.ROOT / "configs" / "human_chr20.json")
    cfg.update(name="small", contig="small1", genome_len=300_000,
               genome_seed=5)
    (tmp / "configs" / "small.json").write_text(json.dumps(cfg))
    for t in ("pe150", "se100"):
        d = world.load_json(world.ROOT / "traffic" / f"{t}.json")
        d.update(batch_records=batch_records)
        (tmp / "traffic" / f"{t}.json").write_text(json.dumps(d))
    bench = world.load_json(world.REPO / "BENCHMARK.json")
    bench["configs"] = [{"name": "small", "file": "configs/small.json"}]
    bench["workloads"] = [
        {"name": "small.pe150", "config": "small", "traffic": "pe150",
         "chips": 1},
        {"name": "small.se100", "config": "small", "traffic": "se100",
         "chips": 1}]
    for m in bench["per_layer"]:
        m["workloads"] = ["small.pe150", "small.se100"]
    return bench
