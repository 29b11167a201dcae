"""int64 positions through the whole port, the counterpart of
tests/test_int64_index.py: a small genome's index and k-mer table widened
to int64 (the width of a text of 2**31 characters or more, GRCh38's) give
every device stage the same values as int32, the packed transfer the same
regions, and the SE and PE aligners the same SAM, byte for byte, equal to
the oracle's too."""
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa_torch.chain.device import (chain_filter, chain_seeds,
                                       seeds_from_smems)
from tpubwa_torch.extend.worker import extend_chains
from tpubwa_torch.index.builder import build_index
from tpubwa_torch.io import fastx
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.pipeline import Aligner
from tpubwa_torch.seed.lut import collect_smems_lut
from tpubwa_torch.tools import dryrun
from tpubwa_torch.utils import dna

from test_torch_pipeline_pe import heavy_error_mates


def widen(aln: Aligner) -> Aligner:
    """The aligner with its DeviceIndex (L2, sa_samples, ann_end) and its
    k-mer table in int64, as chip_smoke.py's int64 phase widens it."""
    aln.didx, aln.lut = dryrun.widen(aln.didx, aln.lut)
    return aln


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(5)
    genome = dna.decode(rng.integers(0, 4, 60_000).astype(np.uint8))
    idx = build_index([("chrT", genome)])
    lut = tmp_path_factory.mktemp("int64") / "lut.npz"
    aln32 = Aligner(idx, MemOptions(), device="cpu", lut_cache=lut)
    aln64 = widen(Aligner(idx, MemOptions(), device="cpu", lut_cache=lut))
    recs = fastx.simulate_reads(dna.encode(genome), 24, read_len=100,
                                error_rate=0.02, indel_rate=0.005, seed=2)
    # pairs with three mates that only the rescue alignment places
    pairs = fastx.simulate_reads(dna.encode(genome), 16, read_len=100,
                                 error_rate=0.01, seed=4, paired=True,
                                 insert_mean=320, insert_std=25)
    heavy_error_mates(dna.encode(genome), pairs, (3000, 9000, 15000), 7, 11)
    return aln32, aln64, fastx.batch_reads(recs), fastx.batch_reads(pairs)


def test_int64_worker1_matches_int32(world):
    aln32, aln64, batch, _ = world
    assert aln32.didx.pos_dtype == torch.int32
    assert aln64.didx.pos_dtype == torch.int64
    seqs = torch.as_tensor(batch.seqs).to(torch.int32)
    lens = torch.as_tensor(batch.lens)
    outs = {}
    for tag, aln in (("32", aln32), ("64", aln64)):
        smems = collect_smems_lut(aln.didx, aln.lut, seqs, lens, aln.scfg)
        seeds = seeds_from_smems(aln.didx, smems, aln.ccfg)
        ch = chain_seeds(aln.didx, seeds, aln.ccfg)
        flt = chain_filter(ch, aln.ccfg)
        st = extend_chains(aln.didx, seqs, lens, seeds, ch, aln.ecfg, flt)
        outs[tag] = (smems, seeds, st)
    for stage, (a, b) in zip(("smems", "seeds", "regions"),
                             zip(outs["32"], outs["64"])):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k].to(torch.int64), b[k].to(torch.int64)), \
                f"{stage}.{k}"
    sm64, sd64, st64 = outs["64"]
    assert sm64["k"].dtype == torch.int64 and sm64["pos"].dtype == torch.int64
    assert sd64["rbeg"].dtype == torch.int64
    assert st64["rb"].dtype == torch.int64
    assert int(st64["n"].sum()) > 0


def test_int64_packed_roundtrip(world):
    """The 6-word packed transfer gives the same regions from int64."""
    aln32, aln64, batch, _ = world
    got = aln64._unpack_host(aln64.worker1_packed(
        batch.seqs, batch.lens).numpy(), batch.n)
    want = aln32._unpack_host(aln32.worker1_packed(
        batch.seqs, batch.lens).numpy(), batch.n)
    assert got[3].dtype == np.int64 and got[3].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_int64_sam_equal(world):
    aln32, aln64, batch, _ = world
    sam64 = aln64.align_se(batch, id0=0)
    assert sam64 == aln32.align_se(batch, id0=0)
    assert sam64 == aln32.oracle.align_se(batch, aln32.opt, id0=0)


def test_int64_pe_sam_equal(world):
    """PE: the rescue windows' positions are int64 too."""
    aln32, aln64, _, pairs = world
    aln64.stats = {"reads": 0, "fallback_reads": 0}
    lib = aln64.oracle._lib
    lib.tb_rescue_miss_reset()
    sam64 = aln64.align_pe(pairs, id0=0)
    assert aln64.stats["rescue_tasks"] > 0
    assert lib.tb_rescue_miss_count() == 0
    assert sam64 == aln32.align_pe(pairs, id0=0)
    assert sam64 == aln32.oracle.align_pe(pairs, aln32.opt, id0=0)[0]
