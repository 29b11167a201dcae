"""tpubwa_torch.tools.scale_bench on the CPU at a tiny size (0.3 Mbp with
the HUMAN profile forced, 16 SE reads, 8 pairs): its JSON rows carry the
reference script's keys, every SAM line equals the oracle's, the caches
are written and read back, and the genome and the index equal the
reference package's."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index as j_build_index
from tpubwa.utils import genome as jgenome
from tpubwa_torch.tools import scale_bench as sb

REPO = Path(__file__).resolve().parents[1]
MBP = 0.3


def reference_keys():
    """The keys of the dict literals that scripts/scale_bench.py prints:
    the SE row's, then the PE row's."""
    tree = ast.parse((REPO / "scripts" / "scale_bench.py").read_text())
    rows = [node.args[0] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                      None) == "dumps"
            and isinstance(node.args[0], ast.Dict)]
    return [{k.value for k in d.keys} for d in sorted(
        rows, key=lambda d: d.lineno)]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    d = tmp_path_factory.mktemp("scale")
    rows = sb.run(16, MBP, pe=True, device="cpu", profile="human",
                  build_dir=d, pe_pairs=8)
    return d, rows


def test_rows_match_the_oracle_with_the_reference_keys(bench):
    _, (se, pe) = bench
    se_keys, pe_keys = reference_keys()
    assert "parity_mismatches" in se_keys and "pe_fallback_pct" in pe_keys
    se, pe = json.loads(json.dumps(se)), json.loads(json.dumps(pe))
    assert se_keys <= set(se) and pe_keys <= set(pe)
    assert se["parity_lines_checked"] >= 16 and se["parity_mismatches"] == 0
    assert pe["parity_lines_checked"] >= 16 and pe["parity_mismatches"] == 0
    assert pe["rescue_results_missing"] == 0
    assert se["pos_dtype"] == "int32" and se["genome_mbp"] == MBP
    assert se["device_bytes"]["index"] > 0 and se["device_bytes"]["lut"] > 0
    for k in ("tier1_ovf", "tier2_rows", "tier3_rows"):
        assert se[k] >= 0 and pe[k] >= 0
    assert {"genome_build_s", "index_build_s", "lut_build_s"} <= \
        set(se["costs"])


def test_caches_are_written_and_read_back(bench):
    d, _ = bench
    glen = int(MBP * 1e6)
    paths = sb.cache_paths(glen, "human", d)
    assert all(p.exists() for p in paths)
    assert "hard_human" in paths[0].name     # not the size's own profile
    costs = {}
    g, idx = sb.prepare(MBP, costs, "human", d)
    assert set(costs) == {"genome_load_s", "index_load_s", "lut_load_s"}
    assert len(g) == glen and idx.l_pac == glen


def test_genome_and_index_equal_the_reference(bench):
    d, _ = bench
    glen = int(MBP * 1e6)
    g = sb.get_genome(MBP, {}, "human", d)
    want = jgenome.synthetic_genome(glen, seed=7, profile=jgenome.HUMAN)
    np.testing.assert_array_equal(g, want)
    assert (want == 4).any()        # the HUMAN profile's N runs
    idx = sb.get_index(MBP, g, {}, "human", d)
    jidx = j_build_index([("scale_synth", want)])
    for f in ("l_pac", "primary", "sa_intv"):
        assert getattr(idx, f) == getattr(jidx, f)
    for f in ("L2", "bwt_words", "occ_cp", "sa_samples", "pac", "ambs"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(jidx, f))
    assert [(a.name, a.offset, a.length) for a in idx.anns] == \
        [(a.name, a.offset, a.length) for a in jidx.anns]


def test_profile_follows_the_size():
    assert sb.default_profile(64) == "human"
    assert sb.default_profile(31.9) == "bacterial"
    a = sb.cache_paths(64_000_000, "human", Path("/nonexistent-unused"))
    assert [p.name for p in a] == ["scale_index_hard_64000000.npz",
                                   "scale_genome_hard_64000000.npy",
                                   "scale_lut_hard_64000000.npz"]


def test_the_card_is_required_without_platform_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.main(["16", "0.3"])
