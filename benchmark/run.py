"""Run one cell of the benchmark of the PyTorch and CUDA aligner.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit (also the last lines of
standard error). Exits non-zero, printing no result, without a CUDA card
(or fewer than the cell asks for), when the aligner's package is missing,
or when the JAX package or JAX itself was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def _env():
    """Caches of the program's builds inside the checkout, at fixed paths;
    transformers (if anything loads it) kept from loading JAX."""
    cache = ROOT / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _env()
    sys.path.insert(0, str(REPO))
    from benchmark import harness, world
    bench = world.load_json(REPO / "BENCHMARK.json")
    cell = world.find_cell(bench, a.workload)
    import torch
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: cell {a.workload} needs {need} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(bench, a.workload, a.seed, a.seconds,
                           bool(a.trace), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; it may load none of "
              f"{list(harness.FORBIDDEN)}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
