"""tpubwa_torch.dist.mesh == tpubwa.dist.mesh, on the CPU.

The tests/test_dist.py world (an 8 kbp genome, 32 reads of 100 bp with 2%
errors): the port's worker1_sharded over a mesh of CPU shards equals the
reference's shard_map over as many virtual CPU devices, key by key, and
the port's own worker1_step on the whole batch; the insert-size histogram
summed over the mesh equals the reference's and np.bincount. All
comparisons are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.dist import mesh as jmesh
from tpubwa.index.builder import build_index
from tpubwa.index.device import DeviceIndex as JDeviceIndex
from tpubwa.io import fastx
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.pipeline import configs_from_opts as jconfigs
from tpubwa.seed.lut import KmerLUT as JKmerLUT
from tpubwa.utils import dna
from tpubwa_torch.dist import mesh as tmesh
from tpubwa_torch.index.builder import FMIndex
from tpubwa_torch.index.device import DeviceIndex
from tpubwa_torch.ops import sw
from tpubwa_torch.opts import MemOptions
from tpubwa_torch.pipeline import configs_from_opts
from tpubwa_torch.seed.lut import KmerLUT

KEYS = ("n", "overflow", "rb", "re", "qb", "qe", "score", "truesc", "w",
        "seedcov", "seedlen0", "rid", "l_rep")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    genome = dna.decode(rng.integers(0, 4, 8000).astype(np.uint8))
    jidx = build_index([("c", genome)])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    recs = fastx.simulate_reads(dna.encode(genome), 32, read_len=100,
                                error_rate=0.02, seed=1)
    batch = fastx.batch_reads(recs)
    jopt, opt = JMemOptions(), MemOptions()
    return dict(
        jdidx=JDeviceIndex.from_host(jidx),
        jlut=JKmerLUT.build(jidx, min_seed_len=jopt.min_seed_len),
        jcfgs=jconfigs(jopt),
        didx=DeviceIndex.from_host(idx, "cpu"),
        lut=KmerLUT.build(idx, min_seed_len=opt.min_seed_len, device="cpu"),
        cfgs=configs_from_opts(opt),
        seqs=batch.seqs.astype(np.int32), lens=batch.lens)


def port_args(world):
    return (world["didx"], torch.as_tensor(world["seqs"]),
            torch.as_tensor(world["lens"]))


@pytest.fixture(scope="module")
def whole(world):
    """The port's worker1_step on the whole batch."""
    scfg, ccfg, ecfg = world["cfgs"]
    return tmesh.worker1_step(*port_args(world), world["lut"], scfg=scfg,
                              ccfg=ccfg, ecfg=ecfg)


def assert_outputs_equal(got: dict, want: dict):
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def reference(world):
    """The reference's worker1_sharded over 8 virtual CPU devices."""
    js, jc, je = world["jcfgs"]
    out = jmesh.worker1_sharded(jmesh.make_mesh(8), world["jdidx"],
                                jnp.asarray(world["seqs"]),
                                jnp.asarray(world["lens"]), js, jc, je,
                                world["jlut"])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_worker1_equals_reference_and_whole_batch(world, whole,
                                                          reference, n):
    scfg, ccfg, ecfg = world["cfgs"]
    mesh = tmesh.make_mesh(n, device="cpu")
    assert mesh.size == n and mesh.axis == tmesh.READS_AXIS
    got = tmesh.worker1_sharded(mesh, *port_args(world), scfg, ccfg, ecfg,
                                world["lut"])
    got = {k: v.numpy() for k, v in got.items()}
    assert_outputs_equal(got, {k: v.numpy() for k, v in whole.items()})
    assert_outputs_equal(got, reference)


def test_split_flags_overflow_as_the_reference_does():
    """A dense budget of the seeding walk is sized from the reads of a
    shard, so splitting a batch can move reads to overflow (to a later
    tier) — in the reference's shard_map as here. A genome with a planted
    three-copy repeat and reads from it fills the budget of a 32-read
    shard but not of the 64-read batch: the port's shards equal the
    reference's, and every read that overflows in neither run equals its
    whole-batch result."""
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 8000).astype(np.uint8)
    g[3000:3300] = g[1000:1300]
    g[5000:5300] = g[1000:1300]
    jidx = build_index([("c", dna.decode(g))])
    idx = FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])
    recs = fastx.simulate_reads(g, 60, read_len=100, error_rate=0.02,
                                seed=1)
    recs += [fastx.FastxRecord(f"rep{p}", dna.decode(g[p:p + 100]))
             for p in (1010, 1050, 1100, 1150)]
    batch = fastx.batch_reads(recs)
    seqs = batch.seqs.astype(np.int32)
    js, jc, je = jconfigs(JMemOptions())
    jd = JDeviceIndex.from_host(jidx)
    jl = JKmerLUT.build(jidx, min_seed_len=19)
    ref = jmesh.worker1_sharded(jmesh.make_mesh(2), jd, jnp.asarray(seqs),
                                jnp.asarray(batch.lens), js, jc, je, jl)
    scfg, ccfg, ecfg = configs_from_opts(MemOptions())
    didx = DeviceIndex.from_host(idx, "cpu")
    lut = KmerLUT.build(idx, min_seed_len=19, device="cpu")
    args = (didx, torch.as_tensor(seqs), torch.as_tensor(batch.lens))
    got = tmesh.worker1_sharded(tmesh.make_mesh(2, device="cpu"), *args,
                                scfg, ccfg, ecfg, lut)
    got = {k: v.numpy() for k, v in got.items()}
    assert_outputs_equal(got, ref)
    whole = tmesh.worker1_step(*args, lut, scfg=scfg, ccfg=ccfg, ecfg=ecfg)
    whole = {k: v.numpy() for k, v in whole.items()}
    moved = got["overflow"] != whole["overflow"]
    assert moved.any()
    kept = ~(got["overflow"] | whole["overflow"])
    for k in KEYS:
        np.testing.assert_array_equal(got[k][kept], whole[k][kept],
                                      err_msg=k)


def test_worker1_step_anchor_config_equals_reference(world):
    """worker1_step seeds through the anchor machine for an anchor config,
    as the reference's does."""
    scfg, ccfg, ecfg = configs_from_opts(MemOptions(), seed_impl="anchor")
    js, jc, je = jconfigs(JMemOptions(), seed_impl="anchor")
    got = tmesh.worker1_sharded(tmesh.make_mesh(2, device="cpu"),
                                *port_args(world), scfg, ccfg, ecfg)
    want = jax.jit(lambda d, s, l: jmesh.worker1_step(
        d, s, l, None, scfg=js, ccfg=jc, ecfg=je))(
        world["jdidx"], jnp.asarray(world["seqs"]),
        jnp.asarray(world["lens"]))
    assert_outputs_equal({k: v.numpy() for k, v in got.items()}, want)


def test_batch_that_does_not_divide_raises(world):
    scfg, ccfg, ecfg = world["cfgs"]
    didx, seqs, lens = port_args(world)
    with pytest.raises(ValueError, match="do not divide over 3"):
        tmesh.worker1_sharded(tmesh.make_mesh(3, device="cpu"), didx, seqs,
                              lens, scfg, ccfg, ecfg, world["lut"])
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.insert_size_psum(tmesh.make_mesh(3, device="cpu"),
                               torch.zeros(64, dtype=torch.int32),
                               torch.ones(64, dtype=torch.bool), 10)


def test_second_call_copies_no_index(world, monkeypatch):
    calls = []
    for cls in (DeviceIndex, KmerLUT):
        real = cls.to

        def counted(self, device, real=real):
            calls.append(type(self).__name__)
            return real(self, device)
        monkeypatch.setattr(cls, "to", counted)
    scfg, ccfg, ecfg = world["cfgs"]
    mesh = tmesh.make_mesh(4, device="cpu")
    first = tmesh.worker1_sharded(mesh, *port_args(world), scfg, ccfg, ecfg,
                                  world["lut"])
    assert sorted(calls) == ["DeviceIndex", "KmerLUT"]   # one device
    reps = mesh.replicate(world["didx"])
    second = tmesh.worker1_sharded(mesh, *port_args(world), scfg, ccfg,
                                   ecfg, world["lut"])
    assert len(calls) == 2
    assert mesh.replicate(world["didx"]) is reps
    assert reps[torch.device("cpu")] is world["didx"]
    assert_outputs_equal(first, second)


def test_replicate_copies_once_per_distinct_device():
    class Probe:
        def __init__(self):
            self.moves = []

        def to(self, device):
            self.moves.append(device)
            return (self, device)
    mesh = tmesh.Mesh(("cpu", "cpu", "meta", "cpu"))
    obj = Probe()
    reps = mesh.replicate(obj)
    assert obj.moves == [torch.device("cpu"), torch.device("meta")]
    assert mesh.replicate(obj) is reps and len(obj.moves) == 2
    other = Probe()
    assert mesh.replicate(other) is not reps and len(other.moves) == 2


def test_insert_size_psum_equals_reference_and_bincount():
    rng = np.random.default_rng(2)
    inserts = rng.integers(0, 900, 64).astype(np.int32)
    inserts[:3] = [-5, 1000, 1500]            # clipped to 0 and max_ins
    ok = rng.random(64) < 0.8
    want = np.bincount(np.clip(inserts, 0, 1000)[ok], minlength=1001)
    jwant = np.asarray(jmesh.insert_size_psum(
        jmesh.make_mesh(8), jnp.asarray(inserts), jnp.asarray(ok),
        max_ins=1000))
    np.testing.assert_array_equal(jwant, want)
    for n in (1, 8):
        got = tmesh.insert_size_psum(tmesh.make_mesh(n, device="cpu"),
                                     torch.as_tensor(inserts),
                                     torch.as_tensor(ok), max_ins=1000)
        assert got.dtype == torch.int32 and got.shape == (1001,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == int(ok.sum())


def test_cuda_mesh_needs_a_card():
    if torch.cuda.is_available():
        mesh = tmesh.make_mesh()
        assert mesh.devices == tuple(torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count()))
        assert tmesh.make_mesh(1).size == 1
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(2, device="cuda")
    assert tmesh.make_mesh(3, device="cpu", local=True).devices == \
        (torch.device("cpu"),) * 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sharded_worker1_on_card_equals_whole_batch(world, whole,
                                                    cuda_device):
    """Four logical shards on one card, each on a stream of its own,
    launch K1 and equal the whole batch on the CPU."""
    scfg, ccfg, ecfg = world["cfgs"]
    mesh = tmesh.Mesh((cuda_device,) * 4)
    didx, seqs, lens = port_args(world)
    before = sw.ksw_extend.launches
    got = tmesh.worker1_sharded(mesh, didx.to(cuda_device),
                                seqs.to(cuda_device), lens.to(cuda_device),
                                scfg, ccfg, ecfg, world["lut"].to(cuda_device))
    assert sw.ksw_extend.launches > before
    assert all(v.device == cuda_device for v in got.values())
    assert_outputs_equal({k: v.cpu().numpy() for k, v in got.items()},
                         {k: v.numpy() for k, v in whole.items()})
