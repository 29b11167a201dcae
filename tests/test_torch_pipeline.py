"""tpubwa_torch SE pipeline: SAM byte-equal to tpubwa.Aligner and the oracle.

The tests/test_pipeline_e2e.py 20 kbp world (two sequences, a planted
repeat) on the CPU: clean, noisy, indel, chimeric, repeat, unmapped and
N-containing reads through Aligner(..., device="cpu").align_se and
align_se_stream. Mixed-length batches and the big-caps tiers have files of
their own (test_torch_pipeline_buckets.py, test_torch_pipeline_tiers.py).
"""
import threading

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index.builder import build_index
from tpubwa.pipeline import Aligner as JAligner
from tpubwa.utils import dna
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.io import fastx
from tpubwa_torch.pipeline import Aligner


def port_index(jidx) -> FMIndex:
    return FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(555)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    g[9000:9250] = g[3000:3250]  # repeat
    genome = dna.decode(g)
    jidx = build_index([("chr1", genome[:12000]), ("chr2", genome[12000:])])
    return jidx, Aligner(port_index(jidx), device="cpu"), dna.encode(genome)


@pytest.fixture(scope="module")
def jaln(world):
    return JAligner(world[0])


def mixed_records(fwd):
    rng = np.random.default_rng(3)
    recs = fastx.simulate_reads(fwd[:12000], 24, read_len=100,
                                error_rate=0.03, indel_rate=0.002, seed=2)
    for i in range(8):
        p = int(rng.integers(0, 11000))
        r = fwd[p:p + 112].copy()
        q = int(rng.integers(15, 85))
        dl = int(rng.integers(1, 7))
        r = (np.concatenate([r[:q], r[q + dl:]]) if i % 2 else
             np.concatenate([r[:q], rng.integers(0, 4, dl).astype(np.uint8),
                             r[q:]]))
        recs.append(fastx.FastxRecord(f"iv{i}", dna.decode(r[:100])))
    for i in range(4):
        p1, p2 = int(rng.integers(0, 11000)), int(rng.integers(0, 11000))
        cut = int(rng.integers(35, 65))
        recs.append(fastx.FastxRecord(f"ch{i}", dna.decode(np.concatenate(
            [fwd[p1:p1 + cut], fwd[p2:p2 + 100 - cut]]))))
    recs += [fastx.FastxRecord(f"rep{p}", dna.decode(fwd[p:p + 100]))
             for p in (9000, 9140, 3050)]
    recs.append(fastx.FastxRecord(
        "junk", dna.decode(rng.integers(0, 4, 100).astype(np.uint8))))
    nread = dna.decode(fwd[500:600])
    recs.append(fastx.FastxRecord("withN", nread[:40] + "N" * 5 + nread[45:]))
    return recs


def test_se_sam_equals_tpubwa_and_oracle(world, jaln):
    jidx, aln, fwd = world
    batch = fastx.batch_reads(mixed_records(fwd))
    got = aln.align_se(batch, id0=0)
    assert got == aln.oracle.align_se(batch, aln.opt, id0=0)
    assert got == jaln.align_se(batch, id0=0)
    assert aln.stats["fallback_reads"] == 0


def test_stream_equals_align_se(world):
    jidx, aln, fwd = world
    whole, batches = stream_reads(fwd)
    full = aln.align_se(whole, id0=0)
    assert "".join(aln.align_se_stream(batches, id0=0)) == full
    # explicit (batch, id0) items leave the numbering to the caller
    items = [(b, 10 * k) for k, b in enumerate(batches)]
    assert "".join(aln.align_se_stream(items, depth=1)) == full


def stream_reads(fwd):
    """30 reads as one batch and as the 3 ten-read batches of the stream
    tests."""
    recs = fastx.simulate_reads(fwd[:12000], 30, read_len=100,
                                error_rate=0.02, seed=5)
    return fastx.batch_reads(recs), [fastx.batch_reads(recs[i:i + 10])
                                     for i in range(0, 30, 10)]


def record_stream(monkeypatch, cls, batches, log, dispatch, finish):
    """Replace cls's _dispatch_se and _finish_se_dispatched with recorders
    that log (call, batch index, id0, thread), then return
    dispatch(self, k, batch) / finish(self, k, batch, parts, id0) for the
    batch of index k."""
    index = {id(b): k for k, b in enumerate(batches)}

    def rec_dispatch(self, b):
        log.append(("dispatch", index[id(b)], None, threading.get_ident()))
        return dispatch(self, index[id(b)], b)

    def rec_finish(self, b, parts, id0):
        log.append(("finish", index[id(b)], id0, threading.get_ident()))
        return finish(self, index[id(b)], b, parts, id0)
    monkeypatch.setattr(cls, "_dispatch_se", rec_dispatch)
    monkeypatch.setattr(cls, "_finish_se_dispatched", rec_finish)


@pytest.fixture(scope="module")
def port_calls():
    """The port's real _dispatch_se and _finish_se_dispatched results on
    the stream batches, by batch index (and id0), shared by the depths of
    the order test."""
    return {}


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_order_and_thread_equal_reference(world, jaln, monkeypatch,
                                                 port_calls, depth):
    """F9: the port's align_se_stream dispatches and finishes the batches
    in the reference's sequence, every call on the calling thread. The
    reference's order is its stream's control flow, recorded with a finish
    that returns the oracle's SAM of the batch at the id0 it was given (so
    no new batch shape is compiled); the port's recorders call its real
    methods (once a batch over the depths)."""
    jidx, aln, fwd = world
    whole, batches = stream_reads(fwd)
    real_d, real_f = Aligner._dispatch_se, Aligner._finish_se_dispatched

    def port_dispatch(self, k, b):
        if k not in port_calls:
            port_calls[k] = real_d(self, b)
        return port_calls[k]

    def port_finish(self, k, b, parts, id0):
        if (k, id0) not in port_calls:
            port_calls[k, id0] = real_f(self, b, parts, id0)
        return port_calls[k, id0]
    jlog, log = [], []
    record_stream(monkeypatch, JAligner, batches, jlog,
                  lambda self, k, b: None,
                  lambda self, k, b, parts, id0: aln.oracle.align_se(
                      b, aln.opt, id0=id0))
    record_stream(monkeypatch, Aligner, batches, log, port_dispatch,
                  port_finish)
    want = "".join(jaln.align_se_stream(batches, id0=0, depth=depth))
    got = "".join(aln.align_se_stream(batches, id0=0, depth=depth))
    assert [e[:3] for e in log] == [e[:3] for e in jlog]
    assert len(log) == 2 * len(batches)
    me = threading.get_ident()
    assert [e[3] for e in log] == [me] * len(log)
    assert got == want == aln.oracle.align_se(whole, aln.opt, id0=0)


def test_header_and_packing_roundtrip(world, jaln):
    jidx, aln, fwd = world
    hdr = aln.sam_header()
    assert "@SQ\tSN:chr1\tLN:12000" in hdr
    assert "@SQ\tSN:chr2\tLN:8000" in hdr
    # the batch shape of the SAM test, so the reference's compiled
    # worker1 is reused
    batch = fastx.batch_reads(mixed_records(fwd)[::-1])
    buf = aln.worker1_packed(batch.seqs, batch.lens).numpy()
    jbuf = np.asarray(jaln.worker1_packed(batch.seqs, batch.lens))
    np.testing.assert_array_equal(buf, jbuf)
    n, ovf, l_rep, flat = aln._unpack_host(buf, batch.n)
    assert flat.shape == (int(n.sum()), 10)


def test_packing_splits_64bit_positions():
    """F3: rb above 2**32 survives the low/high word split exactly."""
    from tpubwa_torch.pipeline import _pack
    R = 2
    rb = torch.tensor([[2**33 + 2**31 + 5, 7], [2**31 - 1, 0]],
                      dtype=torch.int64)
    z = torch.zeros((2, R), dtype=torch.int32)
    st = dict(rb=rb, re=rb + 100, qb=z, qe=z + 100, score=z + 90,
              truesc=z + 90, w=z + 100, seedcov=z + 30, seedlen0=z + 30,
              rid=z, n=torch.tensor([2, 1], dtype=torch.int32),
              overflow=torch.zeros(2, dtype=torch.bool))
    buf = _pack(st, torch.zeros(2, dtype=torch.int32), R, 8).numpy()
    n, ovf, _, flat = Aligner._unpack_host(buf, 2)
    assert list(n) == [2, 1]
    assert list(flat[:, 0]) == [2**33 + 2**31 + 5, 7, 2**31 - 1]
    assert list(flat[:, 1] - flat[:, 0]) == [100, 100, 100]
