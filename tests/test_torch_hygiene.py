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

import torch_cpu  # noqa: F401  (one PyTorch thread a process)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "tpubwa_torch"


def test_import_pulls_in_no_jax_and_no_tpubwa():
    code = ("import sys\n"
            "import tpubwa_torch, tpubwa_torch.pipeline, "
            "tpubwa_torch.ops.sw, tpubwa_torch.ops.sw_local, "
            "tpubwa_torch.ops.cubuild, tpubwa_torch.pair.rescue, "
            "tpubwa_torch.dist.mesh, tpubwa_torch.dist.shard_index, "
            "tpubwa_torch.cli, "
            "tpubwa_torch.io.sam, tpubwa_torch.dist.multihost, "
            "tpubwa_torch.seed.anchor, tpubwa_torch.seed.device, "
            "tpubwa_torch.index.fmquery, tpubwa_torch.utils.profiling, "
            "tpubwa_torch.tools.scale_bench, "
            "tpubwa_torch.tools.bench_world, tpubwa_torch.tools.diag_caps, "
            "tpubwa_torch.tools.diag_scale, tpubwa_torch.tools.diag_tier2, "
            "tpubwa_torch.tools.classify_overflow, "
            "tpubwa_torch.tools.tune_budgets, "
            "tpubwa_torch.tools.profile_phases, "
            "tpubwa_torch.tools.time_stages, tpubwa_torch.tools.time_extend, "
            "tpubwa_torch.tools.profile_finish, "
            "tpubwa_torch.tools.profile_pe, tpubwa_torch.tools.parity, "
            "tpubwa_torch.tools.run_1m, tpubwa_torch.tools.dryrun, "
            "tpubwa_torch.tools.option_sets, "
            "tpubwa_torch.tools.contig_layouts, "
            "tpubwa_torch.tools.long_pairs, "
            "tpubwa_torch.tools.long_reads, "
            "tpubwa_torch.tools.mate_pairs, "
            "tpubwa_torch.tools.trace_cell\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'tpubwa.')) or m == 'tpubwa')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_bench_torch_pulls_in_no_jax_and_no_tpubwa():
    """bench_torch.py and every module its run imports."""
    code = ("import sys\n"
            "import bench_torch, tpubwa_torch.io.fastx, "
            "tpubwa_torch.ops.sw, tpubwa_torch.ops.sw_local, "
            "tpubwa_torch.pipeline, tpubwa_torch.tools.scale_bench\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'tpubwa.')) or m == 'tpubwa')\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"\btpubwa\."])
def test_bench_torch_names_neither(pattern):
    rx = re.compile(pattern, re.IGNORECASE)
    hits = [f"bench_torch.py:{i}: {line.strip()}" for i, line in enumerate(
        (REPO / "bench_torch.py").read_text().splitlines(), 1)
        if rx.search(line)]
    assert not hits, "\n".join(hits)


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


def test_dryrun_without_device_needs_a_card():
    from tpubwa_torch.tools import dryrun
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["2"])


def test_seed_impl_anchor_configs_equal_reference():
    """configs_from_opts(seed_impl="anchor") gives the reference's
    AnchorSeedConfig (and chaining / extension configs) field for field,
    at the tier-1 caps and at both big-caps tiers' caps."""
    import dataclasses

    from tpubwa.opts import MemOptions as JMemOptions
    from tpubwa.pipeline import configs_from_opts as jconfigs
    from tpubwa_torch.opts import MemOptions
    from tpubwa_torch.pipeline import configs_from_opts
    from tpubwa_torch.seed.anchor import AnchorSeedConfig
    for caps in ({}, dict(max_smems=63, max_seeds=640, max_chains=64,
                          max_regs=63, sa_dense=640),
                 dict(max_smems=48, max_seeds=192, max_chains=48,
                      max_regs=48)):
        got = configs_from_opts(MemOptions(min_seed_len=17),
                                seed_impl="anchor", text_len=60000, **caps)
        want = jconfigs(JMemOptions(min_seed_len=17), seed_impl="anchor",
                        text_len=60000, **caps)
        assert isinstance(got[0], AnchorSeedConfig)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
        # the port's ExtendConfig leaves out use_pallas alone
        ext = dataclasses.asdict(got[2])
        jext = dataclasses.asdict(want[2])
        assert ext == {k: v for k, v in jext.items() if k != "use_pallas"}
    with pytest.raises(ValueError, match="seed_impl"):
        configs_from_opts(MemOptions(), seed_impl="fm")


def test_mapq_coef_fac_equals_reference():
    from tpubwa.opts import MemOptions as JMemOptions
    from tpubwa_torch.opts import MemOptions
    for coef in (50.0, 1.5, 1000.0):
        assert MemOptions(mapq_coef_len=coef).mapq_coef_fac == \
            JMemOptions(mapq_coef_len=coef).mapq_coef_fac
