"""tpubwa_torch.tools.dryrun == __graft_entry__.py, on the CPU.

entry("cpu") gives the reference entry()'s (score, n) through jax.jit,
array for array, on the same tiny world; dryrun_multichip over two CPU
shards returns and writes exactly SCALING.json's keys (and its load_test's,
on a stand-in world), with the histogram totals the reference asserts, and
leaves the committed SCALING.json as it was; the LOAD test's genome is the
reference's."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.utils import genome as jgenome
from tpubwa_torch.tools import dryrun

REPO = Path(__file__).resolve().parents[1]
SCALING = REPO / "SCALING.json"


def test_entry_equals_reference():
    fn, args = dryrun.entry("cpu")
    score, n = fn(*args)
    jfn, jargs = ref.entry()
    jscore, jn = jax.jit(jfn)(*jargs)
    assert score.device.type == "cpu" and (n >= 1).all()
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))


@pytest.fixture()
def recorded(monkeypatch):
    """dryrun's two histogram calls, wrapped to keep what they return."""
    got = {"insert_size_psum": [], "pe_hist_psum": []}
    for name in got:
        real = getattr(dryrun, name)

        def wrapper(*a, _real=real, _log=got[name], **kw):
            out = _real(*a, **kw)
            _log.append((a, out))
            return out
        monkeypatch.setattr(dryrun, name, wrapper)
    return got


def test_dryrun_writes_scaling_keys(tmp_path, monkeypatch, recorded):
    monkeypatch.setenv("TPUBWA_DRYRUN_LOAD", "0")
    before = SCALING.read_bytes()
    want = json.loads(before)
    out = tmp_path / "SCALING_torch.json"
    got = dryrun.dryrun_multichip(2, device="cpu", out=out)
    assert SCALING.read_bytes() == before
    assert list(got) == list(want)
    assert json.loads(out.read_text()) == got
    assert got["n_devices"] == 2 and got["per_device_reads"] == 2
    assert got["index_pos_dtype"] == "int64" and got["load_test"] == {}
    assert got["t_1dev_s"] > 0 and got["t_ndev_s"] > 0
    assert "host CPU" in got["note"]
    # the reference's totals: every insert counted, every sampled pair
    (_, hist), = recorded["insert_size_psum"]
    assert int(hist.sum()) == 4
    (args, hist4), *_ = recorded["pe_hist_psum"]
    assert hist4.shape == (4, 1001)
    assert hist4.sum() == int((args[0] >= 0).sum()) > 0


def test_load_test_keys(tmp_path, monkeypatch):
    """The LOAD test on a stand-in for the 2 Mbp world (4 reads an entry
    of the tiny world): its keys are SCALING.json's load_test's."""
    monkeypatch.setenv("TPUBWA_DRYRUN_LOAD", "1")
    monkeypatch.setattr(dryrun, "LOAD_PER_DEV", 4)
    monkeypatch.setattr(dryrun, "medium_world",
                        lambda n_reads, device: dryrun.tiny_world(
                            n_reads, device=device))
    want = json.loads(SCALING.read_text())["load_test"]
    got = dryrun.dryrun_multichip(2, device="cpu",
                                  out=tmp_path / "s.json")["load_test"]
    assert list(got) == list(want)
    assert got["per_device_reads"] == 4 and got["genome_len"] == 2_000_000
    assert got["t_1dev_full_batch_s"] > 0


def test_medium_genome_equals_reference():
    np.testing.assert_array_equal(
        dryrun.medium_genome(),
        jgenome.synthetic_genome(2_000_000, seed=11,
                                 profile=jgenome.BACTERIAL))


def test_widen_gives_int64_index_and_table():
    didx, lut, _, _ = dryrun.tiny_world(4, device="cpu")
    assert didx.pos_dtype == torch.int32 and lut.ksp.dtype == torch.int32
    wd, wl = dryrun.widen(didx, lut)
    assert wd.pos_dtype == torch.int64 and wl.ksp.dtype == torch.int64
    for f in ("L2", "sa_samples", "ann_end"):
        assert torch.equal(getattr(wd, f), getattr(didx, f).to(torch.int64))
    assert torch.equal(wl.ksp, lut.ksp.to(torch.int64))
