"""tpubwa_torch.dist.shard_index == tpubwa.dist.shard_index, on the CPU.

The tests/test_shard_index.py world (a 30 kbp genome; its 938 occ rows do
not divide by 8, so the last shard is padded): the port's shard blocks
equal the reference's shards, and its routed occ / invPsi / SA probes and a
21-step backward search equal both the reference's run_sharded and the
port's replicated DeviceIndex, over 8, 3 and 1 CPU shards and on an index
widened to int64 ranks. All comparisons are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.dist import shard_index as jsh
from tpubwa.dist.mesh import make_mesh as jmake_mesh
from tpubwa.index.builder import build_index
from tpubwa.index.device import DeviceIndex as JDeviceIndex
from tpubwa.utils import dna
from tpubwa_torch.dist import shard_index as tsh
from tpubwa_torch.dist.mesh import Mesh, make_mesh
from tpubwa_torch.index import device as tdev
from tpubwa_torch.index.builder import FMIndex


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(77)
    genome = dna.decode(rng.integers(0, 4, 30_000).astype(np.uint8))
    jidx = build_index([("c1", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    return JDeviceIndex.from_host(jidx), tdev.DeviceIndex.from_host(idx,
                                                                    "cpu")


@pytest.fixture(scope="module", params=[(8, "int32"), (8, "int64"),
                                        (3, "int32"), (1, "int64")],
                ids=lambda p: f"{p[0]}shards-{p[1]}")
def world(indexes, request):
    n, width = request.param
    jd, td = indexes
    if width == "int64":
        jd = dataclasses.replace(jd, L2=jd.L2.astype(jnp.int64),
                                 sa_samples=jd.sa_samples.astype(jnp.int64),
                                 ann_end=jd.ann_end.astype(jnp.int64))
        td = dataclasses.replace(td, L2=td.L2.to(torch.int64),
                                 sa_samples=td.sa_samples.to(torch.int64),
                                 ann_end=td.ann_end.to(torch.int64))
    jmesh, mesh = jmake_mesh(n), make_mesh(n, device="cpu")
    return dict(n=n, jd=jd, td=td, jmesh=jmesh, mesh=mesh,
                jsidx=jsh.ShardedIndex.from_device_index(jd, jmesh),
                sidx=tsh.ShardedIndex.from_device_index(td, mesh))


def ranks(w, seed, size, lo):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, 2 * int(w["td"].l_pac), size)


def jq(w, a):
    return jnp.asarray(a, dtype=w["jd"].L2.dtype)


def tq(w, a):
    return torch.as_tensor(a).to(w["td"].pos_dtype)


def test_shards_equal_reference_shards(world):
    sidx, jsidx, n = world["sidx"], world["jsidx"], world["n"]
    assert sidx.occ_rows_per_shard == jsidx.occ_rows_per_shard
    assert sidx.sa_rows_per_shard == jsidx.sa_rows_per_shard
    assert len(sidx.occ_fused) == len(sidx.sa_samples) == n
    for mine, theirs in ((sidx.occ_fused, jsidx.occ_fused),
                         (sidx.sa_samples, jsidx.sa_samples)):
        shards = sorted(theirs.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == n
        for blk, sh in zip(mine, shards):
            np.testing.assert_array_equal(
                blk.numpy(), np.asarray(sh.data).astype(np.int64))
    # the footprint claim: each shard holds 1/n of the (padded) rows
    whole = sidx.occ_fused[0].shape[0] * n
    assert whole - world["td"].occ_fused.shape[0] < n
    assert all(b.shape[0] * n == whole for b in sidx.occ_fused)
    assert sidx.L2.dtype == world["td"].pos_dtype


def test_occ4_routed_equals_reference_and_replicated(world):
    ks = ranks(world, 1, 512, -1)
    ks[:3] = [-1, world["td"].primary, 2 * world["td"].l_pac]
    want = tdev.occ4_all(world["td"], tq(world, ks))
    got = tsh.run_sharded(world["mesh"], tsh.occ4_all_sharded,
                          world["sidx"], tq(world, ks))
    ref = jsh.run_sharded(world["jmesh"], jsh.occ4_all_sharded,
                          world["jsidx"], jq(world, ks))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_invpsi_routed_equals_reference_and_replicated(world):
    ks = ranks(world, 2, 512, 0)
    ks[:2] = [world["td"].primary, 2 * world["td"].l_pac]
    want = tdev.inv_psi(world["td"], tq(world, ks))
    got = tsh.run_sharded(world["mesh"], tsh.inv_psi_sharded, world["sidx"],
                          tq(world, ks))
    ref = jsh.run_sharded(world["jmesh"], jsh.inv_psi_sharded,
                          world["jsidx"], jq(world, ks))
    assert got.dtype == world["td"].pos_dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sa_walk_routed_equals_reference_and_replicated(world):
    ks = ranks(world, 3, 256, 1)
    valid = np.random.default_rng(3).integers(0, 2, 256).astype(bool)
    want = tdev.sa_lookup(world["td"], tq(world, ks), torch.as_tensor(valid))
    got = tsh.run_sharded(world["mesh"], tsh.sa_lookup_sharded,
                          world["sidx"], tq(world, ks),
                          torch.as_tensor(valid))
    ref = jsh.run_sharded(world["jmesh"], jsh.sa_lookup_sharded,
                          world["jsidx"], jq(world, ks), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy()[valid], want.numpy()[valid])
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(ref)[valid])


def search(xp, step, holder, qs, dt, text):
    """Backward search of every query (B, Q) from its last base, the
    interval (k, s) after each step — tests/test_shard_index.py's, for
    jnp (xp=jnp) or torch (xp=None)."""
    B, Q = qs.shape
    if xp is None:
        k = torch.zeros(B, dtype=dt)
        s = torch.full((B,), text + 1, dtype=dt)
        where, arr, stack = torch.where, torch.as_tensor, torch.stack
        clip0 = lambda v: v.clamp(min=0)   # noqa: E731
    else:
        k, s = xp.zeros((B,), dt), xp.full((B,), text + 1, dt)
        where, arr, stack = xp.where, xp.asarray, xp.stack
        clip0 = lambda v: xp.maximum(v, 0)   # noqa: E731
    ks, ss = [], []
    for j in range(Q - 1, -1, -1):
        c = arr(qs[:, j])
        alive = s > 0
        k2, s2 = step(holder, where(alive, k, 1), where(alive, s, 1),
                      where(alive, c, 0))
        k = where(alive & (s2 > 0), k2, k)
        s = where(alive, clip0(s2), s)
        ks.append(k)
        ss.append(s)
    return stack(ks), stack(ss)


def test_backward_search_routed_equals_reference_and_replicated(world):
    rng = np.random.default_rng(4)
    qs = rng.integers(0, 4, (64, 21)).astype(np.int32)
    text = 2 * int(world["td"].l_pac)
    td, jd = world["td"], world["jd"]
    want = search(None, tdev.backward_ext, td, qs, td.pos_dtype, text)
    got = tsh.run_sharded(
        world["mesh"], lambda h: search(None, tsh.backward_ext_sharded, h,
                                        qs, td.pos_dtype, text),
        world["sidx"])
    ref = jsh.run_sharded(
        world["jmesh"], lambda h: search(jnp, jsh.backward_ext_sharded, h,
                                         qs, jd.L2.dtype, text),
        world["jsidx"])
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int((got[1][-1] > 0).sum()) < 64      # some queries died out


def test_run_sharded_refuses_another_mesh(world):
    other = make_mesh(world["n"], device="cpu")
    with pytest.raises(ValueError, match="another mesh"):
        tsh.run_sharded(other, tsh.occ4_all_sharded, world["sidx"],
                        torch.zeros(4, dtype=world["td"].pos_dtype))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_logical_shards_on_card_equal_replicated(indexes, cuda_device):
    """Four logical shards on one card: the routed probes equal the
    replicated index on the card."""
    td = indexes[1].to(cuda_device)
    mesh = Mesh((cuda_device,) * 4)
    sidx = tsh.ShardedIndex.from_device_index(td, mesh)
    assert all(b.device == cuda_device for b in sidx.occ_fused)
    rng = np.random.default_rng(5)
    ks = torch.as_tensor(rng.integers(1, 2 * td.l_pac, 4096)).to(
        td.pos_dtype).to(cuda_device)
    valid = ks > 0
    for fn, rep, args in ((tsh.occ4_all_sharded, tdev.occ4_all, (ks,)),
                          (tsh.inv_psi_sharded, tdev.inv_psi, (ks,)),
                          (tsh.sa_lookup_sharded, tdev.sa_lookup,
                           (ks, valid))):
        got = tsh.run_sharded(mesh, fn, sidx, *args)
        assert torch.equal(got, rep(td, *args)), fn.__name__
