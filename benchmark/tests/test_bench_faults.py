"""A whole run of the harness on a small world (the program on the CPU,
the look for a card skipped), sound and with the timed path broken
underneath: ``correct`` holds for the sound run and comes out false for
each fault a cell can have, (a) half of a batch's records left out and
(b) an answer altered where the host finish produces it."""
import time

import pytest

import smallworld
from benchmark import harness
from tpubwa_torch.pipeline import Aligner

FINISH = {"small.se100": "_finish_threaded", "small.pe150": "_pe_stage_b"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    return tmp, smallworld.make(tmp, batch_records=128)


def _run(small, wl, trace_on=False):
    tmp, bench = small
    return harness.run_cell(bench, wl, 2**31 + 4242, 0.5, trace_on,
                            time.perf_counter(), device="cpu",
                            cache=tmp / "cache", root=tmp, procs=2,
                            traffic_dir=tmp / "traffic",
                            log=lambda *a, **k: None)


def _half(text: str) -> str:
    lines = text.splitlines(keepends=True)
    return "".join(lines[: len(lines) // 2])


def _alter(text: str) -> str:
    lines = text.splitlines(keepends=True)
    f = lines[0].split("\t")
    f[3] = str(int(f[3]) + 1)             # POS of the first record
    return "".join(["\t".join(f)] + lines[1:])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17])
def test_bench_check_takes_first_and_last(n):
    seed = 2**31 + n
    pick = harness.check_picks(n, seed)
    assert pick[0] == 0 and pick[-1] == n - 1
    assert len(pick) == min(n, 2 + harness.CHECK_DRAWN)
    assert pick == harness.check_picks(n, seed)


@pytest.mark.parametrize("wl", ["small.se100", "small.pe150"])
def test_bench_sound_run_is_correct(small, wl):
    res = _run(small, wl, trace_on=(wl == "small.pe150"))
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert isinstance(res["setup_built"], list)
    assert res["checks"]["sam_lines_differing"] == {"value": 0, "limit": 0}
    if wl == "small.pe150":
        assert "rescue_tasks_per_pair" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"reads_per_s", "setup_s"}


@pytest.mark.parametrize("wl", ["small.se100", "small.pe150"])
@pytest.mark.parametrize("fault", [_half, _alter])
def test_bench_fault_is_not_correct(small, wl, fault, monkeypatch):
    real = getattr(Aligner, FINISH[wl])

    def broken(self, *a, **kw):
        return fault(real(self, *a, **kw))
    monkeypatch.setattr(Aligner, FINISH[wl], broken)
    res = _run(small, wl)
    assert not res["correct"]
    assert res["checks"]["sam_lines_differing"]["value"] > 0
