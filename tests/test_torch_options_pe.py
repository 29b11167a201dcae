"""tpubwa_torch at non-default alignment options, paired-end, and K2's plain
version at each set's scores.

Each named flag set of tpubwa_torch/tools/option_sets.py, through both
packages' command-line mapping:
  * tests/test_pipeline_pe.py's 25 kbp world (tests/test_torch_pipeline_
    pe.py's plain pairs, a heavy-error mate that only the rescue places, a
    junk mate) through Aligner(opt, device="cpu").align_pe: SAM byte-equal
    to tpubwa.pipeline.Aligner(opt) and to the oracle's align_pe, mate
    rescue run with no window missing from the injected results, the same
    number of reads on the oracle's regions as the reference's;
  * ksw_local_ref against the reference's ksw_local_batch and its
    interpreted TPU kernel in both want_sub modes, and against the scalar
    ksw_align, at the set's scores and the rescue's minimum score
    (min_seed_len * a), tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_local import edge_tasks, gen_tasks
from test_torch_options_se import reference_options
from test_torch_pipeline_pe import (assert_same_sam, plain_pairs,  # noqa
                                    rescue_and_junk, world)
from tpubwa.extend.jax_extend import ksw_local_batch
from tpubwa.ops.sw_pallas import ksw_local_pallas
from tpubwa.pair.rescue import _scmat_tuple
from tpubwa.pipeline import Aligner as JAligner
from tpubwa_torch import oracle
from tpubwa_torch.io import fastx
from tpubwa_torch.ops import sw_local
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import option_sets


@pytest.mark.parametrize("name", option_sets.NAMES)
def test_pe_sam_equals_reference_and_oracle_at_option_set(world, name):
    jidx, idx, _, fwd = world
    opt = option_sets.options(name)
    aln = Aligner(idx, opt, device="cpu")
    jaln = JAligner(jidx, reference_options(name))
    batch = fastx.batch_reads(plain_pairs(fwd) + rescue_and_junk(fwd))
    lib = aln.oracle._lib
    lib.tb_rescue_miss_reset()
    got = aln.align_pe(batch, id0=0)
    assert aln.stats["rescue_tasks"] > 0
    assert lib.tb_rescue_miss_count() == 0
    assert got.count("\n") >= batch.n
    assert_same_sam(got, aln.oracle.align_pe(batch, opt, id0=0)[0],
                    "the oracle")
    assert_same_sam(got, jaln.align_pe(batch, id0=0), "tpubwa.Aligner")
    assert aln.stats["reads"] == jaln.stats["reads"] == batch.n
    assert aln.stats["fallback_reads"] == jaln.stats["fallback_reads"]


def local_rows(opt, seed):
    """The K2 task mix of tests/test_local_align.py (random, planted with
    errors, duplicated, N-containing; every 9th row invalid) and its edge
    rows (qlen 0, tlen 0, invalid, all below minsc), the rescue's minimum
    score min_seed_len * a, the target padded to a multiple of 128 for the
    TPU kernel."""
    qs, qlen, ts, tlen = gen_tasks(seed)
    valid = np.ones(len(qlen), np.int32)
    valid[::9] = 0
    eq, eql, et, etl, ev = edge_tasks()
    Q = qs.shape[1]
    T = -(-ts.shape[1] // 128) * 128
    pad = lambda a, w: np.pad(a, ((0, 0), (0, w - a.shape[1])),  # noqa
                              constant_values=4)
    qs = np.concatenate([qs, pad(eq, Q)])
    ts = np.concatenate([pad(ts, T), pad(et, T)])
    qlen, tlen = np.concatenate([qlen, eql]), np.concatenate([tlen, etl])
    valid = np.concatenate([valid, ev])
    minsc = np.full(len(qlen), opt.min_seed_len * opt.a, np.int32)
    return qs, qlen.astype(np.int32), ts, tlen.astype(np.int32), minsc, \
        valid


@pytest.mark.parametrize("name", option_sets.NAMES)
def test_k2_plain_equals_reference_at_option_set(name):
    opt = option_sets.options(name)
    kw = option_sets.scores(opt)
    jkw = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    qs, qlen, ts, tlen, minsc, valid = local_rows(opt, len(name))
    t = [torch.tensor(a) for a in (qs, qlen, ts, tlen, minsc, valid)]
    for want_sub in (True, False):
        got = sw_local.ksw_local_ref(*t, want_sub=want_sub, **kw).numpy()
        scan = np.stack([np.asarray(r) for r in ksw_local_batch(
            jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
            jnp.asarray(tlen), jnp.asarray(valid != 0), jnp.asarray(minsc),
            _scmat_tuple(opt.a, opt.b), *jkw, want_sub)], axis=1)
        kern = np.asarray(ksw_local_pallas(
            jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
            jnp.asarray(tlen), jnp.asarray(minsc), jnp.asarray(valid != 0),
            *jkw, opt.a, opt.b, want_sub=want_sub, interpret=True))
        np.testing.assert_array_equal(got, scan, err_msg=name)
        np.testing.assert_array_equal(got, kern, err_msg=name)
        if want_sub:
            live = np.flatnonzero((valid != 0) & (qlen > 0) & (tlen > 0))
            want = np.array([[oracle.ksw_align_local(
                qs[i, :qlen[i]], ts[i, :tlen[i]], opt, int(minsc[i]))[k]
                for k in ("score", "te", "qe", "score2", "te2")]
                for i in live])
            np.testing.assert_array_equal(got[live], want, err_msg=name)
            assert (got[live, 0] > 0).any()
