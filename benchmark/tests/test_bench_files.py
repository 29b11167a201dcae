"""BENCHMARK.json, its configuration and traffic files, and a reader for
every metric and a generator for every genome and traffic mix load and
agree with one another."""
import importlib
import json
import re

import pytest

from benchmark import world

BENCH = world.load_json(world.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_bench_cell_files_load(wl):
    cell = world.find_cell(BENCH, wl)
    cfg, trf = cell.config, cell.traffic
    assert cfg["name"] == cell.workload["config"]
    assert trf["name"] == cell.workload["traffic"]
    world.mem_options(cfg)
    gen = importlib.import_module(
        f"benchmark.genomes.{cfg['genome']['generator']}")
    reads = importlib.import_module(f"benchmark.reads.{trf['generator']}")
    assert callable(gen.make) and callable(reads.make_batch)
    assert trf["kind"] in ("se", "pe")
    assert trf["batch_records"] % 2 == 0 and int(trf["read_len"]) >= 1
    if trf["kind"] == "pe":
        assert trf["outer_distance"] > 2 * trf["read_len"]


@pytest.mark.parametrize("c", [c["name"] for c in BENCH["configs"]])
def test_bench_genome_entries_have_sources(c):
    entry = {x["name"]: x for x in BENCH["configs"]}[c]
    cfg = world.load_json(world.REPO / entry["file"])
    spec = cfg["genome"]
    assert 0.3 < spec["gc"] < 0.7 and spec["gc_source"]
    parts = list(spec.get("families", []))
    parts += [spec[k] for k in ("segmental_duplications", "microsatellites")
              if k in spec]
    assert parts
    for p in parts:
        assert p["source"]
        assert ("share" in p) != ("copies" in p) or "length" in p \
            or "repeats" in p
        lo, hi = p.get("length_frac", (0, 1))
        assert 0 <= lo <= hi <= 1
        lo, mode, hi = p.get("divergence", (0, 0, 1))
        assert 0 <= lo <= mode <= hi <= 1 and lo < hi
    assert set(entry["reduced"]) <= set(cfg)


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_bench_metric_has_reader(m):
    mod = importlib.import_module(f"benchmark.metrics.{m}")
    assert callable(mod.read)


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["end_to_end"]])
def test_bench_end_to_end_has_reader(m):
    from benchmark.harness import Totals
    mod = importlib.import_module(f"benchmark.end_to_end.{m}")
    v = mod.read(Totals(reads=4096, bases=409600, window_s=2.0,
                        setup_s=20.0))
    assert v > 0


def test_bench_names_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} == {"reads_per_s",
                                                        "setup_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "reads_per_s"
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(BENCH)) < 64 * 1024
