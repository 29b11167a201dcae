"""tpubwa_torch at non-default alignment options, single-end, and K1's plain
version at each set's scores.

Each named flag set of tpubwa_torch/tools/option_sets.py goes through both
packages' command-line mapping into MemOptions, then:
  * tests/test_pipeline_e2e.py's 20 kbp world and tests/test_torch_
    pipeline.py's 36 mixed reads (clean, noisy, indel, chimeric, repeat,
    junk, N) through Aligner(opt, device="cpu").align_se: SAM byte-equal to
    tpubwa.pipeline.Aligner(opt) and to the oracle, and the same number of
    reads left to the oracle as the reference leaves;
  * ksw_extend_ref against the reference's interpreted TPU kernel, its
    vectorised ksw_extend_batch and the scalar oracle at the set's scores,
    tolerance 0, on rows that put h0 just inside, just outside and far
    outside the CUDA kernel's packed key (max(h0, 0) + a * qlen < 2**22)
    for the set's match score, and the band width at the band clip's edge
    (one below, at and above min(max_ins, max_del)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpubwa.cli as jcli
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_pipeline import mixed_records, port_index, world  # noqa: F401
from tpubwa import oracle as joracle
from tpubwa.extend.jax_extend import ksw_extend_batch
from tpubwa.ops.sw_pallas import ksw_extend_pallas
from tpubwa.pipeline import Aligner as JAligner
from tpubwa_torch.io import fastx
from tpubwa_torch.ops import sw
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.tools import option_sets

EB = 5          # end bonus of the kernel rows (the pipeline's pen_clip)
KEY_LIMIT = 1 << 22


def reference_options(name: str):
    """tpubwa.cli's MemOptions for set ``name``'s flags."""
    return jcli.opts_from_args(jcli.build_parser().parse_args(
        ["align", "index.npz", "reads.fq", *option_sets.SETS[name]]))


@pytest.mark.parametrize("name", option_sets.NAMES)
def test_se_sam_equals_reference_and_oracle_at_option_set(world, name):
    jidx, _, fwd = world
    opt, jopt = option_sets.options(name), reference_options(name)
    aln = Aligner(port_index(jidx), opt, device="cpu")
    jaln = JAligner(jidx, jopt)
    batch = fastx.batch_reads(mixed_records(fwd))
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, opt, id0=0)
    assert got == jaln.align_se(batch, id0=0)
    assert aln.stats["reads"] == jaln.stats["reads"] == batch.n
    assert aln.stats["fallback_reads"] == jaln.stats["fallback_reads"]
    assert got.count("\n") >= batch.n


def band_edge(opt, qlen):
    """min(max_ins, max_del) of ksw_extend2's band clip at end bonus EB."""
    max_sc = max(opt.a, -opt.b, -1)
    ins = max((qlen * max_sc + EB - opt.o_ins) // opt.e_ins + 1, 1)
    dele = max((qlen * max_sc + EB - opt.o_del) // opt.e_del + 1, 1)
    return min(ins, dele)


def option_rows(opt, Q, seed, n=16):
    """n extension tasks of query width Q from a numpy seed: planted
    queries with a few errors and random ones; rows 3-5 match their
    targets exactly with h0 = 2**22 - a * qlen - 1, 2**22 - a * qlen and
    2**23 (H climbs to h0 + a * qlen, the packed key's limit on either
    side for this set's a); rows 6-8 the band width one below, at and one
    above the band clip's edge, with h0 = 3 * a * qlen so that cells far
    off the diagonal stay positive; an h0 = 0 row, a qlen = 1 row and an
    invalid row."""
    rng = np.random.default_rng(seed)
    T = Q + 2 * band_edge(opt, Q) + 8
    ta = rng.integers(0, 4, (n, T)).astype(np.int32)
    qa = rng.integers(0, 4, (n, Q)).astype(np.int32)
    for i in range(0, n, 2):
        off = int(rng.integers(0, 8))
        qa[i] = ta[i, off:off + Q]
        pos = rng.integers(0, Q, 3)
        qa[i, pos] = (qa[i, pos] + 1) % 4
    qa[11, rng.integers(0, Q, 2)] = 4              # N bases
    ql = rng.integers(1, Q + 1, n).astype(np.int32)
    tl = rng.integers(1, T + 1, n).astype(np.int32)
    h0 = rng.integers(1, opt.a * Q + 30, n).astype(np.int32)
    w = np.full(n, opt.w, np.int32)
    for i, h in ((3, KEY_LIMIT - 1), (4, KEY_LIMIT), (5, 1 << 23)):
        ql[i], tl[i] = Q, T
        qa[i] = ta[i, :Q]
        h0[i] = h - opt.a * Q if h < 1 << 23 else h
    for i, dw in ((6, -1), (7, 0), (8, 1)):
        ql[i], tl[i] = Q, T
        h0[i] = 3 * opt.a * Q
        w[i] = band_edge(opt, Q) + dw
    h0[9], ql[10] = 0, 1
    valid = np.ones(n, np.int32)
    valid[12] = 0
    return qa, ql, ta, tl, h0, w, np.full(n, EB, np.int32), valid


@pytest.mark.parametrize("name", option_sets.NAMES)
def test_k1_plain_equals_reference_at_option_set(name):
    opt, jopt = option_sets.options(name), reference_options(name)
    kw = option_sets.scores(opt)
    for Q in (100, 151):
        arrs = option_rows(opt, Q, seed=Q + len(name))
        qa, ql, ta, tl, h0, w, eb, valid = arrs
        ref = sw.ksw_extend_ref(*map(torch.tensor, arrs), zdrop=opt.zdrop,
                                **kw).numpy()
        j = [jnp.asarray(a) for a in arrs]
        pal = np.asarray(ksw_extend_pallas(
            *j[:7], j[7].astype(bool), opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins, opt.zdrop, opt.a, opt.b, interpret=True))
        batch = np.stack([np.asarray(x) for x in ksw_extend_batch(
            *j[:7], j[7].astype(bool), jnp.asarray(jopt.scmat.astype(
                np.int32)), None, opt.o_del, opt.e_del, opt.o_ins,
            opt.e_ins, opt.zdrop)], axis=1)
        np.testing.assert_array_equal(ref, pal, err_msg=f"{name} Q={Q}")
        np.testing.assert_array_equal(ref, batch, err_msg=f"{name} Q={Q}")
        live = np.flatnonzero(valid != 0)
        orc = np.array([joracle.ksw_extend(
            qa[i, :ql[i]], ta[i, :tl[i]], jopt, w=int(w[i]), end_bonus=EB,
            h0=int(h0[i]), zdrop=opt.zdrop) for i in live])
        np.testing.assert_array_equal(ref[live], orc, err_msg=name)
        # the limit rows really reach the limit: an exact match scores
        # h0 + a * qlen
        for i in (3, 4, 5):
            assert ref[i, 0] == h0[i] + opt.a * Q
