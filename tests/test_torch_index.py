"""tpubwa_torch index layer == tpubwa's, on the CPU.

Same random ranks through both DeviceIndex implementations, in the int32
world and in an int64-widened world (the dtype a >1 Gbp index uses, see
tests/test_int64_index.py), with packed words whose top bit is set. All
comparisons are exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.index import device as jdev
from tpubwa.index.builder import FMIndex as JFMIndex, build_index
from tpubwa.utils import dna
from tpubwa_torch.index import device as tdev
from tpubwa_torch.index.builder import FMIndex, build_index as t_build_index


def port_index(jidx) -> FMIndex:
    return FMIndex.from_arrays(
        vars(jidx), [(a.name, a.offset, a.length) for a in jidx.anns])


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(77)
    g = rng.integers(0, 4, 12000).astype(np.uint8)
    g[6000:6200] = g[1000:1200]
    genome = dna.decode(g)
    jidx = build_index([("chrA", genome[:5000]), ("chrB", genome[5000:])])
    return jidx, port_index(jidx)


def widen_j(d):
    return dataclasses.replace(d, L2=d.L2.astype(jnp.int64),
                               sa_samples=d.sa_samples.astype(jnp.int64),
                               ann_end=d.ann_end.astype(jnp.int64))


def widen_t(d):
    return dataclasses.replace(d, L2=d.L2.to(torch.int64),
                               sa_samples=d.sa_samples.to(torch.int64),
                               ann_end=d.ann_end.to(torch.int64))


@pytest.fixture(scope="module", params=["int32", "int64"])
def pair(world, request):
    jidx, tidx = world
    jd = jdev.DeviceIndex.from_host(jidx)
    td = tdev.DeviceIndex.from_host(tidx, "cpu")
    if request.param == "int64":
        jd, td = widen_j(jd), widen_t(td)
    return jd, td, request.param


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _ranks(n, rng, size, lo=-1):
    return rng.integers(lo, n + 2, size)


def test_packed_words_have_top_bit(world):
    """The F1 trap: words >= 2**31 must survive as exact int64 values."""
    _, tidx = world
    td = tdev.DeviceIndex.from_host(tidx, "cpu")
    assert int(td.occ_fused[:, 4:].max()) >= 2**31
    assert int(td.pac_rows.max()) >= 2**31
    n_cp = tidx.occ_cp.shape[0]
    words = np.zeros(n_cp * 4, np.uint32)
    words[:len(tidx.bwt_words)] = tidx.bwt_words
    np.testing.assert_array_equal(td.occ_fused[:, 4:].numpy(),
                                  words.reshape(n_cp, 4).astype(np.int64))
    np.testing.assert_array_equal(tdev._popcount32(
        torch.tensor([0xFFFFFFFF, 0x80000001, 0], dtype=torch.int64)
    ).numpy(), [32, 2, 0])


def test_occ_and_base_ops(pair):
    jd, td, dt = pair
    rng = np.random.default_rng(1)
    n = 2 * jd.l_pac
    jt = jnp.int64 if dt == "int64" else jnp.int32
    tt = torch.int64 if dt == "int64" else torch.int32
    k = _ranks(n, rng, 400)
    k = np.concatenate([k, [jd.primary - 1, jd.primary, jd.primary + 1]])
    c = rng.integers(0, 4, len(k))
    _eq(jdev.occ1(jd, jnp.asarray(k, jt), jnp.asarray(c, jnp.int32)),
        tdev.occ1(td, torch.tensor(k, dtype=tt),
                  torch.tensor(c, dtype=torch.int32)))
    _eq(jdev.occ4_all(jd, jnp.asarray(k, jt)),
        tdev.occ4_all(td, torch.tensor(k, dtype=tt)))
    _eq(jdev.occ_prefix(jd, jnp.asarray(np.clip(k, 0, n), jt),
                        jnp.asarray(c, jnp.int32)),
        tdev.occ_prefix(td, torch.tensor(np.clip(k, 0, n), dtype=tt),
                        torch.tensor(c, dtype=torch.int32)))
    j = rng.integers(0, n, 400)
    _eq(jdev.bwt_base(jd, jnp.asarray(j, jt)),
        tdev.bwt_base(td, torch.tensor(j, dtype=tt)))
    _eq(jdev.text_base(jd, jnp.asarray(j, jt)),
        tdev.text_base(td, torch.tensor(j, dtype=tt)))


def test_walk_ops(pair):
    jd, td, dt = pair
    rng = np.random.default_rng(2)
    n = 2 * jd.l_pac
    jt = jnp.int64 if dt == "int64" else jnp.int32
    tt = torch.int64 if dt == "int64" else torch.int32
    k = rng.integers(1, n + 1, 300)
    s = rng.integers(0, 40, 300)
    c = rng.integers(0, 4, 300)
    jk2, js2 = jdev.backward_ext(jd, jnp.asarray(k, jt), jnp.asarray(s, jt),
                                 jnp.asarray(c, jnp.int32))
    tk2, ts2 = tdev.backward_ext(td, torch.tensor(k, dtype=tt),
                                 torch.tensor(s, dtype=tt),
                                 torch.tensor(c, dtype=torch.int32))
    _eq(jk2, tk2)
    _eq(js2, ts2)
    _eq(jdev.inv_psi(jd, jnp.asarray(k, jt)),
        tdev.inv_psi(td, torch.tensor(k, dtype=tt)))
    valid = rng.random(300) < 0.8
    _eq(jdev.sa_lookup(jd, jnp.asarray(k, jt), jnp.asarray(valid)),
        tdev.sa_lookup(td, torch.tensor(k, dtype=tt), torch.tensor(valid)))


def test_npz_written_by_tpubwa_loads(world, tmp_path):
    jidx, _ = world
    path = tmp_path / "idx.npz"
    jidx.save(path)
    got = FMIndex.load(path)
    for f in ("l_pac", "primary", "sa_intv"):
        assert getattr(got, f) == getattr(jidx, f)
    for f in ("L2", "bwt_words", "occ_cp", "sa_samples", "pac", "ambs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jidx, f))
        assert getattr(got, f).dtype == getattr(jidx, f).dtype
    assert [(a.name, a.offset, a.length) for a in got.anns] == \
        [(a.name, a.offset, a.length) for a in jidx.anns]
    # and back: the port writes the same format
    path2 = tmp_path / "idx2.npz"
    got.save(path2)
    back = JFMIndex.load(path2)
    np.testing.assert_array_equal(back.occ_cp, jidx.occ_cp)


def test_build_index_matches_tpubwa():
    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 3000).astype(np.uint8)
    seq = dna.decode(g)
    seq = seq[:1000] + "NNNNN" + seq[1005:]
    jidx = build_index([("a", seq[:1700]), ("b", seq[1700:])])
    tidx = t_build_index([("a", seq[:1700]), ("b", seq[1700:])])
    for f in ("l_pac", "primary", "sa_intv"):
        assert getattr(tidx, f) == getattr(jidx, f)
    for f in ("L2", "bwt_words", "occ_cp", "sa_samples", "pac", "ambs"):
        np.testing.assert_array_equal(getattr(tidx, f), getattr(jidx, f))


def test_get_base_equals_tpubwa(world):
    jidx, tidx = world
    rng = np.random.default_rng(11)
    text = 2 * jidx.l_pac
    for pos in [0, jidx.l_pac - 1, jidx.l_pac, text - 1,
                *rng.integers(0, text, 500)]:
        assert tidx.get_base(int(pos)) == jidx.get_base(int(pos))


def test_pac_base_and_pos2rid_equal_tpubwa(world):
    """The two host methods on the two-contig index: pac_base at every
    forward position (the reverse-strand half of the text reads the same
    bytes at its forward mirror, as get_base shows), pos2rid at both ends
    of each contig, on the reverse-strand half (-1, as past the last
    contig) and at random positions."""
    jidx, tidx = world
    rng = np.random.default_rng(12)
    L = jidx.l_pac
    assert [tidx.pac_base(p) for p in range(L)] == \
        [int(jidx.pac_base(p)) for p in range(L)]
    for q in (L, L + 4999, 2 * L - 1):
        assert 3 - tidx.pac_base(2 * L - 1 - q) == jidx.get_base(q)
    edges = [0, 1, 4999, 5000, 5001, L - 1]
    for pos in [*edges, L, L + 1, 2 * L - 1, *rng.integers(0, 2 * L, 300)]:
        assert tidx.pos2rid(int(pos)) == jidx.pos2rid(int(pos))
    assert [tidx.pos2rid(p) for p in (0, 4999, 5000, L - 1, L)] == \
        [0, 0, 1, 1, -1]


def test_unpack_2bit_equals_tpubwa():
    from tpubwa_torch.utils import dna as tdna
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, 1001).astype(np.uint8)
    pac = dna.pack_2bit(codes)
    for n in (0, 1, 3, 4, 5, 1000, 1001):
        got = tdna.unpack_2bit(pac, n)
        np.testing.assert_array_equal(got, dna.unpack_2bit(pac, n))
        np.testing.assert_array_equal(got, codes[:n])
        assert got.dtype == np.uint8


def test_device_index_and_lut_move_whole_or_not_at_all(world):
    from tpubwa_torch.seed.lut import KmerLUT
    _, tidx = world
    td = tdev.DeviceIndex.from_host(tidx, "cpu")
    assert td.to("cpu") is td
    moved = td.to("meta")
    assert (moved.l_pac, moved.primary, moved.sa_intv) == \
        (td.l_pac, td.primary, td.sa_intv)
    for f in dataclasses.fields(td):
        v = getattr(moved, f.name)
        if isinstance(v, torch.Tensor):
            assert v.device.type == "meta" and v.dtype == \
                getattr(td, f.name).dtype and v.shape == \
                getattr(td, f.name).shape, f.name
    lut = KmerLUT(4, torch.zeros((256, 2), dtype=torch.int32))
    assert lut.to("cpu") is lut
    assert lut.to("meta").ksp.device.type == "meta" and lut.to("meta").k0 == 4
