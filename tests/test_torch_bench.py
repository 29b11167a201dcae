"""bench_torch.py on the CPU at a tiny size (a 0.1 Mbp bench genome,
TPUBWA_BENCH_BATCH=64 and TPUBWA_BENCH_TIMED=2, 8 pairs a PE batch): its
line carries every key of the dict bench.py prints plus "card", its rates
and shares are in range, its timed windows follow bench.py's formulas, and
without a card it raises."""
import ast
import contextlib
import io
import json
import re
from pathlib import Path

import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
import bench_torch

REPO = Path(__file__).resolve().parents[1]


def reference_keys() -> set:
    """The keys of the dict literal bench.py passes to json.dumps."""
    tree = ast.parse((REPO / "bench.py").read_text())
    rows = [node.args[0] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                      None) == "dumps"
            and isinstance(node.args[0], ast.Dict)]
    assert len(rows) == 1
    return {k.value for k in rows[0].keys}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUBWA_BENCH_BATCH", "64")
    mp.setenv("TPUBWA_BENCH_TIMED", "2")
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            line = bench_torch.run(
                "cpu", build_dir=tmp_path_factory.mktemp("bench"),
                genome_len=100_000, pe_batch=8)
    finally:
        mp.undo()
    return line, err.getvalue()


def test_line_has_the_reference_keys(bench):
    line, _ = bench
    line = json.loads(json.dumps(line))
    assert set(line) == reference_keys() | {"card"}
    assert line["card"] == "cpu"
    assert set(line["phase_s_per_batch"]) == {"device", "transfer",
                                              "host_finish"}


def test_rates_and_shares_in_range(bench):
    line, _ = bench
    assert line["value"] > 0 and line["pe_150bp_reads_per_s"] > 0
    assert line["vs_baseline"] == round(line["value"] / 250_000.0, 4)
    for k in ("fallback_pct", "pe_fallback_pct", "device_busy_pct"):
        assert 0 <= line[k] <= 100, k
    assert line["setup_s"] >= 0


def test_windows_follow_the_reference(bench):
    """SE: TIMED batches of BATCH reads after one warm-up batch. PE:
    bench.py's count 2 * PE_BATCH * 3 is taken in pairs, so 6 batches of
    PE_BATCH pairs, 5 of them timed (20,480 reads at PE_BATCH 2048)."""
    _, err = bench
    m = re.search(r"timed (\d+) reads .*PE (\d+) reads in (\d+) batches of "
                  r"(\d+) pairs", err)
    assert m, err
    se, pe, pe_batches, pairs = map(int, m.groups())
    assert se == 64 * 2
    assert (pe_batches, pairs) == (5, 8) and pe == pe_batches * 2 * pairs
    real = bench_torch.PE_BATCH
    assert (2 * real * 3 // real - 1) * 2 * real == 20_480
    assert "kernel launches in the timed runs" in err


def test_knobs_read_the_reference_variables(monkeypatch):
    monkeypatch.delenv("TPUBWA_BENCH_BATCH", raising=False)
    monkeypatch.delenv("TPUBWA_BENCH_TIMED", raising=False)
    assert bench_torch.knobs() == (4096, 8)
    monkeypatch.setenv("TPUBWA_BENCH_BATCH", "512")
    monkeypatch.setenv("TPUBWA_BENCH_TIMED", "3")
    assert bench_torch.knobs() == (512, 3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_run_without_device_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])
