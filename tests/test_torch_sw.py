"""Banded extension: tpubwa_torch's plain version == the reference kernels.

ksw_extend_ref must be bit-equal to the Pallas kernel run in interpret
mode, to the vectorised JAX reference ksw_extend_batch and to the scalar
oracle, on the tests/test_sw_pallas.py generator, the narrow band + z-drop
case, and invalid, qlen=0 and tlen=0 rows; and to the first two on the
shapes where the CUDA kernel changes instance (query widths around the
multiples of 32, full-width and one-base queries, h0 at the packed key's
limit, bands that go empty). The CUDA kernel is held to the same plain
version on the card (marked `cuda`, skipped without one); which instance a
width takes, and what the wrapper refuses, is tested here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sw_pallas import gen
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa import oracle
from tpubwa.extend.jax_extend import ksw_extend_batch
from tpubwa.ops.sw_pallas import ksw_extend_pallas
from tpubwa.opts import MemOptions
from tpubwa_torch.ops import cubuild, sw

OPT = MemOptions()
KW = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins,
          a=OPT.a, b=OPT.b)


def task_arrays(tasks, w, eb=5):
    N = len(tasks)
    Q = max(len(q) for q, _, _ in tasks)
    T = max(len(t) for _, t, _ in tasks)
    qa = np.full((N, Q), 4, np.int32)
    ta = np.full((N, T), 4, np.int32)
    ql, tl, h0 = (np.zeros(N, np.int32) for _ in range(3))
    for i, (q, t, h) in enumerate(tasks):
        qa[i, :len(q)] = q
        ta[i, :len(t)] = t
        ql[i], tl[i], h0[i] = len(q), len(t), h
    valid = np.ones(N, np.int32)
    # edge rows: an invalid task, an empty query, an empty target
    valid[1] = 0
    ql[2] = 0
    tl[3] = 0
    return (qa, ql, ta, tl, h0, np.full(N, w, np.int32),
            np.full(N, eb, np.int32), valid)


def run_all(tasks, w, zdrop):
    arrs = task_arrays(tasks, w)
    qa, ql, ta, tl, h0, ww, eb, valid = arrs
    t = [torch.tensor(a) for a in arrs]
    ref = sw.ksw_extend_ref(*t, zdrop=zdrop, **KW).numpy()
    j = [jnp.asarray(a) for a in arrs]
    pal = np.asarray(ksw_extend_pallas(
        *j[:7], j[7].astype(bool), OPT.o_del, OPT.e_del, OPT.o_ins,
        OPT.e_ins, zdrop, OPT.a, OPT.b, interpret=True))
    batch = np.stack([np.asarray(x) for x in ksw_extend_batch(
        *j[:7], j[7].astype(bool), jnp.asarray(OPT.scmat.astype(np.int32)),
        None, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, zdrop)], axis=1)
    live = valid.astype(bool) & (ql > 0) & (tl > 0)
    orc = np.array([oracle.ksw_extend(qa[i, :ql[i]], ta[i, :tl[i]], OPT,
                                      w=w, end_bonus=5, h0=int(h0[i]),
                                      zdrop=zdrop)
                    for i in np.flatnonzero(live)])
    return ref, pal, batch, orc, live


@pytest.mark.parametrize("seed,w,zdrop", [(0, 100, 100), (1, 100, 100),
                                          (2, 100, 100), (42, 3, 10)])
def test_ref_matches_pallas_batch_and_oracle(seed, w, zdrop):
    rng = np.random.default_rng(seed)
    ref, pal, batch, orc, live = run_all(gen(rng, 24), w, zdrop)
    np.testing.assert_array_equal(ref, pal)
    np.testing.assert_array_equal(ref, batch)
    np.testing.assert_array_equal(ref[live], orc)
    # rows that never run report the initial state
    np.testing.assert_array_equal(
        ref[~live][:, 1:], np.tile([0, 0, 0, -1, 0], ((~live).sum(), 1)))


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    t = [torch.tensor(a) for a in task_arrays(gen(rng, 12), 100)]
    before = sw.ksw_extend.launches
    got = sw.ksw_extend(*t, zdrop=100, **KW)
    assert sw.ksw_extend.launches == before       # no kernel launched
    np.testing.assert_array_equal(
        got.numpy(), sw.ksw_extend_ref(*t, zdrop=100, **KW).numpy())
    stats = {}
    sw.ksw_extend_ref(*t, zdrop=100, **KW, stats=stats)
    assert stats["cells"] > 0


# query widths at and around the register instances' boundaries (multiples
# of 32), the widest register instance (288) and the generic one beyond
BOUNDARY_Q = (31, 32, 33, 127, 128, 129, 160, 256, 288, 300)


def boundary_arrays(Q, seed, n=12):
    """n tasks of query width Q from a numpy seed: planted and random
    queries; rows with qlen = Q and qlen = 1; h0 just inside, just outside
    and far outside what the kernel's packed key holds
    (max(h0, 0) + a * qlen < 2**22, with queries that match their targets
    exactly so that H reaches that sum; 2**23 as the far value, since the
    interpreted TPU kernel is exact only while scores stay below 2**24) and
    h0 = 0; bands of half-width 0, 1, 3 and 100 in turn, so that some go
    empty."""
    rng = np.random.default_rng(seed)
    T = Q + 24
    ta = rng.integers(0, 4, (n, T)).astype(np.int32)
    qa = rng.integers(0, 4, (n, Q)).astype(np.int32)
    for i in range(0, n, 2):                       # planted, a few errors
        off = int(rng.integers(0, 8))
        qa[i] = ta[i, off:off + Q]
        pos = rng.integers(0, Q, 3)
        qa[i, pos] = (qa[i, pos] + 1) % 4
    qa[5, rng.integers(0, Q, 2)] = 4               # N bases
    ql = rng.integers(1, Q + 1, n).astype(np.int32)
    ql[0], ql[1], ql[2] = Q, 1, Q
    tl = rng.integers(1, T + 1, n).astype(np.int32)
    tl[0], tl[3] = T, 1
    h0 = rng.integers(1, Q + 30, n).astype(np.int32)
    h0[6] = (1 << 22) - ql[6] - 1
    h0[7] = (1 << 22) - ql[7]
    h0[8] = 1 << 23
    h0[9] = 0
    for i in (6, 7, 8):                # exact matches: H really climbs to
        qa[i] = ta[i, :Q]              # h0 + a * qlen
        tl[i] = T
    w = np.array([0, 1, 3, 100] * n, np.int32)[:n]
    w[0], w[6:9] = 100, 100
    valid = np.ones(n, np.int32)
    valid[10] = 0
    return qa, ql, ta, tl, h0, w, np.full(n, 5, np.int32), valid


@pytest.mark.parametrize("Q", BOUNDARY_Q)
def test_ref_matches_pallas_and_batch_on_boundary_shapes(Q):
    arrs = boundary_arrays(Q, seed=Q)
    t = [torch.tensor(a) for a in arrs]
    ref = sw.ksw_extend_ref(*t, zdrop=100, **KW).numpy()
    j = [jnp.asarray(a) for a in arrs]
    pal = np.asarray(ksw_extend_pallas(
        *j[:7], j[7].astype(bool), OPT.o_del, OPT.e_del, OPT.o_ins,
        OPT.e_ins, 100, OPT.a, OPT.b, interpret=True))
    batch = np.stack([np.asarray(x) for x in ksw_extend_batch(
        *j[:7], j[7].astype(bool), jnp.asarray(OPT.scmat.astype(np.int32)),
        None, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, 100)], axis=1)
    np.testing.assert_array_equal(ref, pal)
    np.testing.assert_array_equal(ref, batch)
    assert ref[0, 0] > ref[9, 0] >= 0      # the sweep is not all dead rows


@pytest.mark.parametrize("Q,instance", [
    (1, 1), (31, 1), (32, 1), (33, 2), (100, 4), (128, 4), (129, 5),
    (150, 5), (160, 5), (161, 6), (256, 8), (257, 9), (288, 9), (289, 0),
    (1024, 0), (3000, 0), (32768, 0)])
def test_kernel_instance_follows_query_width(Q, instance):
    """K = ceil(Q / 32) columns a lane up to MAX_K, the generic instance
    (0) beyond; the width alone decides."""
    assert sw.kernel_instance(Q) == instance
    if instance:
        assert 32 * (instance - 1) < Q <= 32 * instance <= 32 * sw.MAX_K


def test_kernel_instance_refuses_what_no_instance_holds():
    # the generic instance keeps four int rows per task in shared memory
    # over min(ring, Q + 1) columns (the ring a power of two of at least
    # 2w + 2 for the band w), four tasks a block: up to the widest
    # (Q + 1)-column row that fits, any band; past it, a band whose ring
    # does not fit raises, and the options' bands fit
    fits = cubuild.SMEM_MAX // (cubuild.WARPS * 4 * 4) - 1
    assert sw.kernel_instance(fits, 10**6) == 0
    with pytest.raises(ValueError, match="shared memory"):
        sw.kernel_instance(fits + 1, 10**6)
    assert sw.kernel_instance(fits + 1, 100) == 0
    assert sw.kernel_instance(fits + 1) == 0


def test_launch_refuses_bad_penalties_and_cpu_tensors():
    rng = np.random.default_rng(5)
    t = [torch.tensor(a) for a in task_arrays(gen(rng, 4), 100)]
    before = sw.ksw_extend.launches
    with pytest.raises(ValueError, match="penalties"):
        sw.launch_kernel(t, 4, zdrop=100, **dict(KW, e_del=0))
    with pytest.raises(ValueError, match="penalties"):
        sw.launch_kernel(t, 4, zdrop=100, **dict(KW, o_ins=-1))
    with pytest.raises(ValueError, match="unsupported device"):
        sw.launch_kernel(t, 4, zdrop=100, **KW)
    assert sw.ksw_extend.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,w,zdrop", [(0, 100, 100), (42, 3, 10)])
def test_kernel_matches_plain_on_card(cuda_device, seed, w, zdrop):
    rng = np.random.default_rng(seed)
    t = [torch.tensor(a).to(cuda_device)
         for a in task_arrays(gen(rng, 64), w)]
    before = sw.ksw_extend.launches
    got = sw.ksw_extend(*t, zdrop=zdrop, **KW)
    assert sw.ksw_extend.launches == before + 1
    want = sw.ksw_extend_ref(*t, zdrop=zdrop, **KW)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("Q", BOUNDARY_Q)
def test_kernel_matches_plain_on_boundary_shapes(cuda_device, Q, n):
    """Every instance a width can take (the one the wrapper picks and the
    generic one) against the plain version, at N = 1 and at the tier-3
    width N = 128."""
    arrs = boundary_arrays(Q, seed=Q + n, n=max(n, 12))
    if n == 1:                       # row 0: a full-width planted query
        arrs = tuple(a[:1] for a in arrs)
    t = [torch.tensor(a).to(cuda_device) for a in arrs]
    want = sw.ksw_extend_ref(*t, zdrop=100, **KW).cpu().numpy()
    got = sw.ksw_extend(*t, zdrop=100, **KW)
    generic = sw.launch_kernel(t, 0, zdrop=100, **KW)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(generic.cpu().numpy(), want)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_input(cuda_device):
    rng = np.random.default_rng(3)
    t = [torch.tensor(a).to(cuda_device) for a in task_arrays(gen(rng, 8),
                                                              100)]
    with pytest.raises(ValueError):
        sw.ksw_extend(t[0].to(torch.int64), *t[1:], zdrop=100, **KW)
    with pytest.raises(ValueError):
        sw.ksw_extend(t[0].t(), *t[1:], zdrop=100, **KW)
    with pytest.raises(RuntimeError, match="launch failed"):
        sw.launch_kernel(t, 1, zdrop=100, **KW)   # K = 1 cannot hold Q
