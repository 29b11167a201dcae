"""tpubwa_torch mixed read lengths: the length-bucketed dispatch gives SAM
byte-equal to tpubwa.Aligner and to the oracle (the
tests/test_mixed_lengths.py world: 60/100 bp reads in a batch padded to
250 lanes, one device call per 64-lane bucket, each with its own caps;
and a batch padded wider than its only bucket)."""
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(404)
    g = rng.integers(0, 4, 30000).astype(np.uint8)
    g[20000:20400] = g[5000:5400]          # a planted duplicate
    jidx = build_index([("chrX", dna.decode(g))])
    tidx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return jidx, Aligner(tidx, device="cpu"), g


def mixed_records(g, rng, lengths=(60, 100), n=30):
    recs = []
    for i in range(n):
        L = int(lengths[i % len(lengths)])
        p = int(rng.integers(0, len(g) - L))
        frag = g[p:p + L].copy()
        for q in rng.integers(0, L, int(rng.integers(0, 3))):
            frag[q] = (frag[q] + 1 + rng.integers(0, 3)) % 4
        if rng.integers(0, 2):
            frag = dna.revcomp(frag)
        recs.append(fastx.FastxRecord(f"mix_{i}_{p}", dna.decode(frag)))
    return recs


def test_mixed_batch_matches_tpubwa_and_oracle(world):
    jidx, aln, g = world
    batch = fastx.batch_reads(mixed_records(g, np.random.default_rng(7)),
                              max_len=250)
    assert [p[2] for p in aln._dispatch_se(batch)] == [128] * 2
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert got == JAligner(jidx).align_se(batch, id0=0)


def test_single_bucket_padded_wide(world):
    jidx, aln, g = world
    recs = mixed_records(g, np.random.default_rng(9), lengths=(76,), n=12)
    batch = fastx.batch_reads(recs, max_len=250)
    parts = aln._dispatch_se(batch)
    assert len(parts) == 1 and parts[0][0] is None
    assert aln.align_se(batch, id0=3) == \
        aln.oracle.align_se(batch, aln.opt, id0=3)
