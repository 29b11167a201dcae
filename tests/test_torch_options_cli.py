"""tpubwa_torch's command line at non-default alignment options.

The flag sets of tpubwa_torch/tools/option_sets.py map to the same
MemOptions in both packages (every field and the derived split_len, scmat
and mapq_coef_fac); ``align`` with the scaled2 and knobs flags writes SE
and two-file PE files byte-equal to tpubwa.cli's on tests/test_torch_
cli.py's 9 kbp world; and ``-E 0``, which both packages take without a
check, makes both command lines exit non-zero (a division by the gap
extension penalty), as the reference does.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import tpubwa.cli as jcli
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_cli import REPO, align_args, world  # noqa: F401
from test_torch_options_se import reference_options
from tpubwa_torch import cli
from tpubwa_torch.tools import option_sets


@pytest.mark.parametrize("name", option_sets.NAMES)
def test_options_map_as_in_reference(name):
    opt, jopt = option_sets.options(name), reference_options(name)
    assert dataclasses.asdict(opt) == dataclasses.asdict(jopt)
    assert opt != type(opt)()                  # the flags moved something
    assert opt.split_len == jopt.split_len
    assert opt.mapq_coef_fac == jopt.mapq_coef_fac
    np.testing.assert_array_equal(opt.scmat, jopt.scmat)


@pytest.mark.parametrize("mode", ["se", "pe_two_files"])
@pytest.mark.parametrize("name", ["scaled2", "knobs"])
def test_align_file_equals_reference_cli_at_option_set(world, name, mode):
    d, _ = world
    flags = list(option_sets.SETS[name])
    got, want = d / f"{name}.{mode}.port.sam", d / f"{name}.{mode}.ref.sam"
    assert cli.main(align_args(d, mode, got) + flags) == 0
    assert jcli.main(align_args(d, mode, want) + flags) == 0
    text = got.read_text()
    assert text == want.read_text()
    body = [l for l in text.splitlines() if not l.startswith("@")]
    assert len(body) >= 24


def test_zero_gap_extension_exits_nonzero_in_both(world, tmp_path):
    """-E 0: neither command line checks it; both fail when the extension
    divides by it (the reference with ZeroDivisionError, the port with
    PyTorch's integer division error), and exit non-zero."""
    d, _ = world
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    for pkg in ("tpubwa_torch", "tpubwa"):
        out = tmp_path / f"{pkg}.sam"
        r = subprocess.run(
            [sys.executable, "-m", pkg, *align_args(d, "se", out), "-E",
             "0"], env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode != 0, pkg
        assert "ZeroDivisionError" in r.stderr, r.stderr[-2000:]
