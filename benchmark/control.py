"""The control of a cell's correctness check: the plain reference with one of
the configuration's guarantees broken (``check.CONTROL``: bwa's re-seeding
of long, rare SMEMs left out) put in the program's place, on as many batches
of each seed as a run compares, at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

Prints, a seed a line, the number a run compares (``sam_lines_differing``)
for the control, and one JSON line at the end. The benchmark's own runs do
not run it; it needs no card. ``tests/test_bench_reference.py`` keeps it at
a size a test run holds.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def control_readings(bench, workload, seeds, cache=None, procs=None,
                     root=None, traffic_dir=None, log=print) -> dict:
    from benchmark import check, harness, world
    cell = world.find_cell(bench, workload, root or world.REPO,
                           traffic_dir or world.ROOT / "traffic")
    cfg, trf = cell.config, cell.traffic
    cache = cache or world.CACHE
    paired = trf["kind"] == "pe"
    g = world.genome(cfg, cache)
    d = check.ensure_ref_index(cfg, g, cache)
    procs = procs or check.default_procs()
    out = {}
    with check.Reference(cfg, d, procs) as ref, \
            check.Reference(cfg, d, procs, **check.CONTROL) as ctl:
        for seed in seeds:
            t0 = time.perf_counter()
            diff = 0
            for j in range(2 + harness.CHECK_DRAWN):
                b = world.make_batch(trf, g, seed, j)
                id0 = j * (b.n // 2 if paired else b.n)
                diff += check.lines_differing(ctl.sam(b, id0, paired),
                                              ref.sam(b, id0, paired))
            out[seed] = diff
            log(f"control {workload} seed {seed}: sam_lines_differing {diff}"
                f" (limit 0), {time.perf_counter() - t0:.1f} s",
                file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT.parent))
    from benchmark import world
    bench = world.load_json(world.REPO / "BENCHMARK.json")
    r = control_readings(bench, a.workload, a.seeds)
    print(json.dumps({"workload": a.workload, "control": "no re-seeding",
                      "sam_lines_differing": r,
                      "least": min(r.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
