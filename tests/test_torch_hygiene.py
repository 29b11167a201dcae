"""tpubwa_torch stands alone: it imports neither JAX nor the reference
package, names neither in its sources, and never runs on the CPU unless
the caller asks for it."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "tpubwa_torch"


def test_import_pulls_in_no_jax_and_no_tpubwa():
    code = ("import sys\n"
            "import tpubwa_torch, tpubwa_torch.pipeline, "
            "tpubwa_torch.ops.sw, tpubwa_torch.ops.sw_local, "
            "tpubwa_torch.ops.cubuild, tpubwa_torch.pair.rescue, "
            "tpubwa_torch.dist.mesh\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'tpubwa.')) or m == 'tpubwa')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\btpubwa\."])
def test_sources_name_neither(pattern):
    rx = re.compile(pattern, re.IGNORECASE)
    hits = []
    for f in sorted(PKG.rglob("*")):
        if f.suffix not in (".py", ".cu", ".cuh", ".h"):
            continue
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if rx.search(line):
                hits.append(f"{f.relative_to(REPO)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_aligner_without_device_needs_a_card():
    from tpubwa_torch.index.builder import build_index
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.utils import dna
    rng = np.random.default_rng(0)
    idx = build_index([("c", dna.decode(rng.integers(0, 4, 2000)
                                        .astype(np.uint8)))])
    if torch.cuda.is_available():
        assert Aligner(idx).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Aligner(idx)
    assert Aligner(idx, device="cpu").device.type == "cpu"


def test_seed_impl_anchor_not_ported():
    from tpubwa_torch.opts import MemOptions
    from tpubwa_torch.pipeline import configs_from_opts
    with pytest.raises(NotImplementedError, match="anchor"):
        configs_from_opts(MemOptions(), seed_impl="anchor")
