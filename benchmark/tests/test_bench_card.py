"""One short run of a cell through the benchmark's command on a CUDA card:
the line it prints has every key the driver reads, ``correct`` true, and
its checks last. Skips, with the reason, where the process sees no card."""
import json
import subprocess
import sys

import pytest

from benchmark import world


@pytest.mark.cuda
def test_bench_cell_runs_on_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ecoli_k12.pe150",
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=world.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
