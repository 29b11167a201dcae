"""tpubwa_torch's tier-1 overflow diagnostics on a repeat world, held to
the reference package's computation on the same reads, count for count:
tools/diag_caps.py and tools/tune_budgets.py, the counterparts of
scripts/diag_caps.py and scripts/tune_budgets.py, with the computation
each script makes done by the reference package's stage functions and
Aligner methods on the CPU. Also: Aligner._tier_configs gives the
configurations the reference's tiers run, and tune_budgets reads the
overflow flag where the packing puts it (the reference script's bit 6
misses every overflowing read)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.chain import device as jchain
from tpubwa.extend import worker as jworker
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.seed.lut import LutSeedConfig as JLutSeedConfig
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import diag_caps, diag_tier2, tune_budgets
from test_torch_pipeline_tiers import repeat_world, tier_batch

STAGES = diag_caps.STAGES


def ref_stage_flags(jaln, seqs, lens, cfgs=None) -> dict:
    """scripts/diag_caps.py's jitted stages on the reference aligner: the
    cumulative overflow after each stage and the SMEM, chain and region
    counts a read."""
    scfg, ccfg, ecfg = cfgs = tuple(cfgs or (jaln.scfg, jaln.ccfg,
                                             jaln.ecfg))

    def stages(didx, lut, seqs, lens):
        smems = jaln._collect_smems(didx, seqs, lens, lut, scfg)
        seeds = jchain.seeds_from_smems(didx, smems, ccfg)
        ch = jchain.chain_seeds(didx, seeds, ccfg)
        st = jworker.extend_chains(didx, seqs, lens, seeds, ch, ecfg,
                                   jchain.chain_filter(ch, ccfg))
        return (smems["overflow"], seeds["overflow"],
                ch.get("overflow", seeds["overflow"]), st["overflow"],
                smems["n"], ch["n"], st["n"])
    # one compiled function an aligner and configuration
    jitted = vars(jaln).setdefault("_diag_stages", {})
    if cfgs not in jitted:
        jitted[cfgs] = jax.jit(stages)
    out = jitted[cfgs](jaln.didx, jaln.lut, jnp.asarray(seqs.astype(np.int32)),
                 jnp.asarray(lens))
    return dict(zip(STAGES + ("n_smems", "n_chains", "n_regs"),
                    (np.asarray(x) for x in out)))


def ref_counts(f: dict, k=None) -> dict:
    """The counts scripts/diag_caps.py prints, from ref_stage_flags."""
    o = {s: f[s][:k] for s in STAGES}
    return {"overflow": {s: int(o[s].sum()) for s in STAGES},
            "added": {s: int((o[s] & ~o[p]).sum())
                      for p, s in zip(STAGES, STAGES[1:])},
            **{name: [float(np.percentile(f[f"n_{name}"], 50)),
                      float(np.percentile(f[f"n_{name}"], 95)),
                      int(f[f"n_{name}"].max())]
               for name in ("smems", "chains", "regs")}}


@pytest.fixture(scope="module")
def world():
    """The 200-copy world of tests/test_torch_pipeline_tiers.py: its
    repeat read overflows tier 1 (200 seeds an SMEM), and the batch-wide
    dense budgets push two more reads over."""
    jidx, tidx, g, unit = repeat_world(55, 200, 200, 40, 3000, 2)
    batch = tier_batch(g, unit, 6, 2900)
    aln = Aligner(tidx, device="cpu")
    jaln = JAligner(jidx)
    return aln, jaln, batch


def test_diag_caps_equals_reference(world):
    aln, jaln, batch = world
    got = diag_caps.diag_caps(aln, batch)
    want = ref_counts(ref_stage_flags(jaln, batch.seqs, batch.lens))
    assert {k: got[k] for k in want} == want
    assert got["caps"] == dict(smems=32, seeds=128, chains=32, regs=32)
    assert got["batch"] == batch.n and got["overflow"]["extend"] >= 1
    assert got["first_s"] > 0 and got["steady_s"] > 0


@pytest.mark.parametrize("variant", [{}, {"offdiag_dense": 4}],
                         ids=["base", "offdiag_dense=4"])
def test_tune_budgets_equals_reference(world, variant):
    """A variant's overflow is the reference's _make_packed buffer's,
    unpacked by the reference's _unpack_host."""
    aln, jaln, batch = world
    got = tune_budgets.tune_budgets(aln, batch, [variant], reps=1)
    fn = jaln._make_packed(dataclasses.replace(jaln.scfg, **variant),
                           jaln.ccfg, jaln.ecfg)
    buf = np.asarray(fn(jaln.didx, jaln.lut, jnp.asarray(batch.seqs),
                        jnp.asarray(batch.lens)))
    want = int(jaln._unpack_host(buf, batch.n)[1].sum())
    (row,) = got["variants"]
    assert row["variant"] == tune_budgets.tag(variant)
    assert row["overflow"] == want > 0
    assert row["w1_ms"] > 0 and got["reps"] == 1


def test_tune_budgets_reads_the_flag_at_bit_10(world):
    """scripts/tune_budgets.py counts ((counts >> 6) & 1): bit 6 belongs to
    the region count, which is 0 on an overflowed read, so it misses every
    read that tune_budgets counts on the same buffer."""
    aln, _, batch = world
    got = tune_budgets.tune_budgets(aln, batch, [{}], reps=1)
    buf = aln._make_packed(aln.scfg, aln.ccfg, aln.ecfg)(
        aln._to_device(batch.seqs), aln._to_device(batch.lens)).numpy()
    counts = buf[:batch.n]
    ovf = aln._unpack_host(buf, batch.n)[1]
    assert got["variants"][0]["overflow"] == ovf.sum() == \
        ((counts >> 10) & 1).sum() >= 1
    assert ((counts >> 6) & 1).sum() == 0
    assert (counts[ovf] & 1023 == 0).all()


def test_default_sweep_and_variant_syntax():
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "scripts" /
           "tune_budgets.py").read_text()
    lists = [ast.literal_eval(n.value) for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.List)
             and getattr(n.targets[0], "id", "") == "variants"]
    assert [list(tune_budgets.DEFAULT_VARIANTS)] == lists
    assert tune_budgets.parse_variant("fm_dense=8,offdiag_dense=4") == \
        {"fm_dense": 8, "offdiag_dense": 4}
    assert tune_budgets.tag({"max_reseed": 4}) == "max_reseed=4"
    assert tune_budgets.tag({}) == "base"


def captured_configs(jaln, tier: int):
    """(scfg, ccfg, ecfg, cap_factor) that the reference's tier builds."""
    got = []
    kept = (getattr(jaln, "_packed_big", None),
            getattr(jaln, "_packed_big3", None))
    jaln._packed_big = jaln._packed_big3 = None
    jaln._make_packed = lambda *a, **kw: got.append(
        (*a, kw.get("cap_factor", jaln.CAP_FACTOR))) or (lambda *x: None)
    try:
        (jaln._packed_big_fn if tier == 2 else jaln._packed_big3_fn)()
    finally:
        del jaln._make_packed
        jaln._packed_big, jaln._packed_big3 = kept
    return got[0]


@pytest.mark.parametrize("tier", [2, 3])
def test_tier_configs_equal_reference(world, tier):
    aln, jaln, _ = world
    got = aln._tier_configs(tier)
    want = captured_configs(jaln, tier)
    assert isinstance(want[0], JLutSeedConfig)
    for g, w in zip(got[:2], want[:2]):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    ext = dataclasses.asdict(want[2])
    assert dataclasses.asdict(got[2]) == \
        {k: v for k, v in ext.items() if k != "use_pallas"}
    assert got[3] == want[3]
    with pytest.raises(ValueError, match="tier"):
        aln._tier_configs(1)


@pytest.mark.parametrize("tool", [diag_caps, tune_budgets, diag_tier2])
def test_the_card_is_required_without_platform_cpu(tool):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
