"""tpubwa_torch K2 (unbanded local SW, the ksw_align forward pass).

The plain version ``ksw_local_ref`` against the reference's scan-level
``ksw_local_batch``, the reference's TPU kernel ``ksw_local_pallas`` in
interpret mode (both ``want_sub`` modes) and the scalar oracle, on the
task mix of tests/test_local_align.py, and against the first two on the
shapes where the CUDA kernel changes instance (query widths around the
multiples of 32, full-width and one-base queries). Tolerance 0: scores and
coordinates are integers. The CUDA kernel is held to the same plain version
on the card (marked `cuda`, skipped without one); which instance a width
takes, and what the wrapper refuses, is tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.extend.jax_extend import ksw_local_batch
from tpubwa.ops.sw_pallas import ksw_local_pallas
from tpubwa.pair.rescue import _scmat_tuple
from tpubwa_torch import oracle
from tpubwa_torch.ops import sw_local
from tpubwa_torch.opts import MemOptions

OPT = MemOptions()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
          e_ins=OPT.e_ins, a=OPT.a, b=OPT.b)
JKW = (OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins)


def gen_tasks(seed, n=48, maxq=100, maxt=320):
    """Mix of random, planted (with errors), duplicated (subopt hits), and
    N-containing tasks — the score2 run-splitting quirk needs repeats."""
    rng = np.random.default_rng(seed)
    qs = np.full((n, maxq), 4, np.int32)
    ts = np.full((n, maxt), 4, np.int32)
    qlen = rng.integers(5, maxq + 1, n).astype(np.int32)
    tlen = rng.integers(10, maxt + 1, n).astype(np.int32)
    for i in range(n):
        t = rng.integers(0, 4, tlen[i]).astype(np.int32)
        q = rng.integers(0, 4, qlen[i]).astype(np.int32)
        if i % 3 == 0 and tlen[i] > qlen[i]:
            off = rng.integers(0, tlen[i] - qlen[i] + 1)
            q = t[off:off + qlen[i]].copy()
            nerr = rng.integers(0, 6)
            pos = rng.integers(0, qlen[i], nerr)
            q[pos] = (q[pos] + rng.integers(1, 4, nerr)) % 4
        if i % 5 == 0 and tlen[i] > 2 * qlen[i]:
            off2 = rng.integers(qlen[i], tlen[i] - qlen[i] + 1)
            t[off2:off2 + qlen[i]] = q % 4
        if i % 7 == 0:
            q[rng.integers(0, qlen[i], 2)] = 4
        qs[i, :qlen[i]] = q
        ts[i, :tlen[i]] = t
    return qs, qlen, ts, tlen


def edge_tasks():
    """The invalid and empty rows of tests/test_local_align.py (row 0 a
    full-length hit, then qlen 0, tlen 0, valid 0) plus a valid row whose
    every row maximum stays below minsc."""
    qs = np.zeros((5, 16), np.int32)
    ts = np.zeros((5, 32), np.int32)
    ts[4] = 1
    qlen = np.array([8, 0, 8, 8, 8], np.int32)
    tlen = np.array([16, 16, 0, 16, 16], np.int32)
    valid = np.array([1, 1, 1, 0, 1], np.int32)
    return qs, qlen, ts, tlen, valid


def port(qs, qlen, ts, tlen, minsc, valid, want_sub, fn=None):
    fn = fn or sw_local.ksw_local_ref
    t = [torch.tensor(np.asarray(a, np.int32))
         for a in (qs, qlen, ts, tlen, minsc, valid)]
    return fn(*t, want_sub=want_sub, **KW).numpy()


def reference_scan(qs, qlen, ts, tlen, minsc, valid, want_sub):
    out = ksw_local_batch(
        jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
        jnp.asarray(tlen), jnp.asarray(valid != 0), jnp.asarray(minsc),
        _scmat_tuple(OPT.a, OPT.b), *JKW, want_sub)
    return np.stack([np.asarray(r) for r in out], axis=1)


def reference_kernel(qs, qlen, ts, tlen, minsc, valid, want_sub):
    return np.asarray(ksw_local_pallas(
        jnp.asarray(qs), jnp.asarray(qlen), jnp.asarray(ts),
        jnp.asarray(tlen), jnp.asarray(minsc), jnp.asarray(valid != 0),
        *JKW, OPT.a, OPT.b, want_sub=want_sub, interpret=True))


def cases(seed):
    if seed == "edge":
        qs, qlen, ts, tlen, valid = edge_tasks()
    else:
        qs, qlen, ts, tlen = gen_tasks(seed)
        valid = np.ones(len(qlen), np.int32)
        valid[::9] = 0
    minsc = np.full(len(qlen), OPT.min_seed_len * OPT.a, np.int32)
    return qs, qlen, ts, tlen, minsc, valid


@pytest.mark.parametrize("want_sub", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, "edge"])
def test_ref_matches_reference_scan(seed, want_sub):
    args = cases(seed)
    np.testing.assert_array_equal(port(*args, want_sub),
                                  reference_scan(*args, want_sub))


@pytest.mark.parametrize("want_sub", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, "edge"])
def test_ref_matches_interpreted_tpu_kernel(seed, want_sub):
    args = cases(seed)
    if seed != "edge":     # the kernel's target width is a multiple of 128
        args = (*args[:2], np.pad(args[2], ((0, 0), (0, 64)),
                                  constant_values=4), *args[3:])
    np.testing.assert_array_equal(port(*args, want_sub),
                                  reference_kernel(*args, want_sub))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_matches_scalar_oracle(seed):
    """The forward pass alone against the scalar ksw_align: score, te, qe,
    score2, te2 (the scalar start extraction is covered with
    ksw_align_batch in test_torch_rescue.py)."""
    qs, qlen, ts, tlen, minsc, _ = cases(seed)
    got = port(qs, qlen, ts, tlen, minsc, np.ones_like(qlen), True)
    want = np.array([
        [oracle.ksw_align_local(qs[i, :qlen[i]], ts[i, :tlen[i]], OPT,
                                int(minsc[i]))[k]
         for k in ("score", "te", "qe", "score2", "te2")]
        for i in range(len(qlen))])
    np.testing.assert_array_equal(got, want)


def test_edge_rows_report_no_alignment():
    args = cases("edge")
    got = port(*args, True)
    assert list(got[0]) == [8, 7, 7, 0, -1]
    for r in (1, 2, 3):
        assert list(got[r]) == [0, -1, -1, 0, -1]
    assert got[4][0] == 0


def test_wrapper_uses_plain_version_for_cpu_tensors_only():
    args = cases(1)
    before = sw_local.ksw_local.launches
    np.testing.assert_array_equal(
        port(*args, True, fn=sw_local.ksw_local), port(*args, True))
    assert sw_local.ksw_local.launches == before
    meta = [torch.tensor(np.asarray(a, np.int32)).to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        sw_local.ksw_local(*meta, want_sub=True, **KW)


def test_shared_memory_budget():
    # a register instance keeps nothing in shared memory: the row maxima of
    # want_sub go to a device-memory workspace of T ints a task
    assert sw_local.smem_bytes(256) == 0
    assert sw_local.workspace_bytes(100, 1024, True) == 100 * 1024 * 4
    assert sw_local.workspace_bytes(100, 1024, False) == 0
    # the generic instance keeps four rows over the query, whatever T
    assert sw_local.smem_bytes(256, instance=0) == 16 * 1024
    assert sw_local.smem_bytes(320) == 20 * 1024
    assert sw_local.smem_bytes(4096) > sw_local._SMEM_MAX


# query widths at and around the register instances' boundaries (multiples
# of 32), the widest register instance (256) and the generic one beyond
BOUNDARY_Q = (31, 32, 33, 64, 65, 128, 129, 256, 257)


def boundary_cases(Q, n=12, T=128):
    """n tasks of query width Q from a numpy seed: the gen_tasks mix, with
    rows of qlen = Q, qlen = 1, qlen = 32 and 33 (a lane boundary inside
    the task's own split), tlen = 1 and tlen = T, an invalid row."""
    qs, qlen, ts, tlen = gen_tasks(1000 + Q, n=n, maxq=Q, maxt=T)
    rng = np.random.default_rng(Q)
    for i in (0, 2):                   # full-width queries: fill the tail
        qs[i, qlen[i]:] = rng.integers(0, 4, Q - qlen[i])
        qlen[i] = Q
    qlen[1], qlen[3], qlen[4] = 1, min(32, Q), min(33, Q)
    qs[3], qs[4] = np.where(qs[3] > 3, 0, qs[3]), np.where(qs[4] > 3, 1, qs[4])
    tlen[5], tlen[0] = 1, T
    valid = np.ones(n, np.int32)
    valid[6] = 0
    minsc = np.full(n, OPT.min_seed_len * OPT.a, np.int32)
    return qs, qlen, ts, tlen, minsc, valid


@pytest.mark.parametrize("want_sub", [True, False])
@pytest.mark.parametrize("Q", BOUNDARY_Q)
def test_ref_matches_scan_and_kernel_on_boundary_shapes(Q, want_sub):
    args = boundary_cases(Q)
    got = port(*args, want_sub)
    np.testing.assert_array_equal(got, reference_scan(*args, want_sub))
    np.testing.assert_array_equal(got, reference_kernel(*args, want_sub))
    assert got[0, 0] > 0 and got[6, 0] == 0


@pytest.mark.parametrize("Q,instance", [
    (1, 1), (32, 1), (33, 2), (100, 4), (128, 4), (129, 5), (150, 5),
    (151, 5), (160, 5), (161, 6), (256, 8), (257, 0), (1024, 0)])
def test_kernel_instance_follows_query_width(Q, instance):
    """K = ceil(Q / 32) columns a lane up to MAX_K, the generic instance
    (0) beyond; the width alone decides."""
    assert sw_local.kernel_instance(Q) == instance
    if instance:
        assert 32 * (instance - 1) < Q <= 32 * instance <= \
            32 * sw_local.MAX_K


def test_launch_refuses_oversized_rows_and_cpu_tensors():
    args = [torch.tensor(np.asarray(a, np.int32)) for a in cases(2)]
    before = sw_local.ksw_local.launches
    n = len(args[1])
    wide = torch.zeros((n, 65536), dtype=torch.int32)
    # a view of MAX_T + 1 columns that allocates nothing
    past = torch.zeros((n, 1), dtype=torch.int32).expand(
        n, sw_local.MAX_T + 1)
    with pytest.raises(ValueError, match="unsupported device"):
        sw_local.launch_kernel(args, 4, want_sub=True, **KW)
    # the row maxima are in device memory: a wide target only meets the
    # device check, in both passes
    for want_sub in (True, False):
        with pytest.raises(ValueError, match="unsupported device"):
            sw_local.launch_kernel([args[0], args[1], wide, *args[3:]], 4,
                                   want_sub=want_sub, **KW)
    with pytest.raises(ValueError, match=f"T={sw_local.MAX_T + 1}"):
        sw_local.launch_kernel([args[0], args[1], past, *args[3:]], 4,
                               want_sub=True, **KW)
    q = torch.zeros((n, 4096), dtype=torch.int32)
    with pytest.raises(ValueError, match="Q=4096.*shared memory"):
        sw_local.launch_kernel([q, *args[1:]], 0, want_sub=True, **KW)
    assert sw_local.ksw_local.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("want_sub", [True, False])
@pytest.mark.parametrize("seed", [0, "edge"])
def test_kernel_matches_plain_on_card(cuda_device, seed, want_sub):
    t = [torch.tensor(np.asarray(a, np.int32)).to(cuda_device)
         for a in cases(seed)]
    before = sw_local.ksw_local.launches
    got = sw_local.ksw_local(*t, want_sub=want_sub, **KW)
    assert sw_local.ksw_local.launches == before + 1
    want = sw_local.ksw_local_ref(*t, want_sub=want_sub, **KW)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("want_sub", [True, False])
@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("Q", BOUNDARY_Q)
def test_kernel_matches_plain_on_boundary_shapes(cuda_device, Q, n, want_sub):
    """Every instance a width can take (the one the wrapper picks and the
    generic one) against the plain version, at N = 1 and N = 128."""
    args = boundary_cases(Q, n=max(n, 12), T=200)
    if n == 1:                       # row 0: a full-width query
        args = tuple(a[:1] for a in args)
    t = [torch.tensor(np.asarray(a, np.int32)).to(cuda_device) for a in args]
    kw = dict(KW, want_sub=want_sub)
    want = sw_local.ksw_local_ref(*t, **kw).cpu().numpy()
    got = sw_local.ksw_local(*t, **kw)
    generic = sw_local.launch_kernel(t, 0, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(generic.cpu().numpy(), want)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_input(cuda_device):
    t = [torch.tensor(np.asarray(a, np.int32)).to(cuda_device)
         for a in cases(2)]
    with pytest.raises(ValueError):
        sw_local.ksw_local(t[0].to(torch.int64), *t[1:], want_sub=True, **KW)
    with pytest.raises(ValueError):
        sw_local.ksw_local(t[0].t(), *t[1:], want_sub=True, **KW)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((len(t[1]), 4096), dtype=torch.int32,
                          device=cuda_device)
        sw_local.ksw_local(big, *t[1:], want_sub=True, **KW)
    with pytest.raises(RuntimeError, match="launch failed"):
        sw_local.launch_kernel(t, 1, want_sub=True, **KW)  # K = 1 < Q / 32
