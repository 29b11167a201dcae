"""tpubwa_torch's tools/diag_tier2.py, the counterpart of
scripts/diag_tier2.py, held to the reference package's computation on a
repeat world where a read overflows tier 1 and tier 2: tier-1 overflow,
the overflow after tier 2 and after the tiers, the merged regions, and
the stage breakdown of the reads left, under tier 2's own configuration
(Aligner._tier_configs(2), which the script's configuration lacks parts
of) and under the script's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.pipeline import configs_from_opts as jconfigs
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import diag_caps, diag_tier2
from test_torch_diag import captured_configs, ref_counts, ref_stage_flags
from test_torch_pipeline_tiers import GATES, repeat_world, tier_batch


def ref_script_configs(jaln):
    """scripts/diag_tier2.py:66-74: the configuration it breaks down."""
    scfg, ccfg, ecfg = jconfigs(
        jaln.opt, seed_impl=jaln.seed_impl, text_len=2 * int(jaln.idx.l_pac),
        max_smems=63, max_seeds=640, max_chains=64, max_regs=63)
    scfg = dataclasses.replace(scfg, fm_dense=4, offdiag_dense=2, r2_rows=1)
    return scfg, ccfg, dataclasses.replace(ecfg, tail_rows=1)


def ref_diag_tier2(jaln, batch, breakdown=True):
    """The counts diag_tier2 returns, by the reference: worker1_packed and
    _tier2 as scripts/diag_tier2.py calls them (the overflow after tier 2
    alone from _tier2_dispatch and _tier2_merge), and with ``breakdown``
    that of the reads left by the reference's stage functions. Returns
    (counts, _tier2's arrays)."""
    buf = np.asarray(jaln.worker1_packed(jnp.asarray(batch.seqs),
                                         jnp.asarray(batch.lens)))
    n, ovf, l_rep, flat = jaln._unpack_host(buf, batch.n)
    final = jaln._tier2(batch, n.copy(), ovf.copy(), l_rep.copy(), flat)
    t2 = jaln._tier2_dispatch(batch, ovf)
    after2 = jaln._tier2_merge(batch, n.copy(), ovf.copy(), l_rep.copy(),
                               flat, t2)[1] if t2 is not None else ovf
    rows = np.flatnonzero(final[1])
    want = {"batch": batch.n, "tier1_overflow": int(ovf.sum()),
            "tier2_fired": t2 is not None,
            "after_tier2": int(after2.sum()), "after_tiers": len(rows),
            "after_tier2_rows": np.flatnonzero(after2).tolist(),
            "left_rows": rows.tolist()}
    if len(rows) and breakdown:
        pad = (-len(rows)) % jaln.TIER2_ROWS
        rsel = np.concatenate([rows, np.repeat(rows[-1:], pad)])
        for key, cfgs in (("tier2_config", captured_configs(jaln, 2)[:3]),
                          ("script_config", ref_script_configs(jaln))):
            f = ref_counts(ref_stage_flags(jaln, batch.seqs[rsel],
                                           batch.lens[rsel], cfgs),
                           len(rows))
            want[key] = {"rows": len(rows), "overflow": f["overflow"],
                         "smems_max": f["smems"][2],
                         "regs_max": f["regs"][2]}
    return want, final


@pytest.fixture(scope="module")
def tier3_world():
    """~800 copies: the repeat read overflows tier 1 and tier 2 (beyond
    640 seeds); with tier 2's gate lowered and tier 3's left at 8 reads,
    it is left for the oracle, and diag_tier2 breaks it down."""
    jidx, tidx, g, unit = repeat_world(56, 120, 800, 10, 2000, 1)
    batch = tier_batch(g, unit, 7, 1900)
    aln = Aligner(tidx, device="cpu")
    jaln = JAligner(jidx)
    for a in (aln, jaln):
        vars(a).update(GATES[2])
    return aln, jaln, batch


def test_diag_tier2_equals_reference(tier3_world, monkeypatch):
    aln, jaln, batch = tier3_world
    seen = []
    real = diag_caps.stage_flags
    monkeypatch.setattr(diag_caps, "stage_flags", lambda a, s, l, cfgs:
                        seen.append(cfgs) or real(a, s, l, cfgs))
    got = diag_tier2.diag_tier2(aln, batch)
    want, final = ref_diag_tier2(jaln, batch)
    assert {k: got[k] for k in want} == want
    assert want["tier1_overflow"] >= 1 and want["tier2_fired"]
    assert want["after_tiers"] >= 1        # tier 3 stays closed
    assert got["tier2_config"]["overflow"]["extend"] == got["after_tiers"]
    # the breakdown runs tier 2's configuration, then the script's
    assert seen == [aln._tier_configs(2)[:3], diag_tier2.script_configs(aln)]
    # run_tiers merges what the pipeline's _tiers and the reference's
    # _tier2 merge
    n, ovf, l_rep, flat = aln._unpack_host(aln.worker1_packed(
        batch.seqs, batch.lens).numpy(), batch.n)
    mine = diag_tier2.run_tiers(aln, batch, n, ovf, l_rep, flat)[0]
    for a, b, c in zip(mine, aln._tiers(batch, n, ovf, l_rep, flat), final):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_diag_tier2_without_steady_run_counts_the_same(tier3_world, capsys):
    """steady=False (chip_smoke.py's full call) runs the tiers once: the
    same counts and rows as with the steady run, no "steady" times, and a
    report without the steady line."""
    aln, _, batch = tier3_world
    full = diag_tier2.diag_tier2(aln, batch)
    once = diag_tier2.diag_tier2(aln, batch, steady=False)
    assert "steady" in full and "steady" not in once
    for k in ("tier1_overflow", "tier2_fired", "after_tier2", "after_tiers",
              "after_tier2_rows", "left_rows", "tier2_config",
              "script_config"):
        assert once[k] == full[k], k
    diag_tier2.report(once)
    out = capsys.readouterr().out
    assert "# tier2: ovf" in out and "steady" not in out
