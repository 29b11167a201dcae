"""Sharded-index mode: the FM-index split by genome coordinate across the
mesh (SURVEY.md §2.5 "index sharding (optional TP analog)").

The replicated index costs ~6.5 GB a device at GRCh38 scale (docs/
SCALING.md); sharding the big arrays over N devices cuts that to ~1/N plus
the replicated small remainder, at the price of one routed round per index
probe. Of the big arrays, the fused occ rows and the sampled SA are
sharded; the packed genome (``pac``, ``pac_rows``) is not, and no probe
here reads it.

Routing: every probe is a (rank -> row) lookup whose owner is shard
``row // rows_per_shard``. A round hands the whole query block to every
shard (queries are a few KB, the rows are the gigabytes); each shard
answers the queries whose rows it owns from its own block and answers 0
elsewhere; the disjoint answers are summed on the controller
(``mesh.devices[0]``, ``dist.mesh.psum``). Traffic a round is
O(mesh * queries), independent of the index size.

The probes keep the ``(index-like, rank) -> count`` signatures of
``index.device`` and share its per-row arithmetic, so a sharded probe
differs from the replicated one only in how the row is fetched.
[bwa: bwt.c :: bwt_occ, bwt_invPsi, bwt_sa]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index.device import (DeviceIndex, inv_psi_from_row, occ4_from_row,
                            occ_from_row, occ_row_of, stored_prefix)
from .mesh import Mesh, psum


@dataclasses.dataclass
class ShardedIndex:
    """A DeviceIndex whose occ_fused and sa_samples are split row-wise over
    the mesh: shard i owns rows [i * R, (i + 1) * R) of each (zero rows pad
    the last shard), held on ``mesh.devices[i]``. L2 and ann_end lie on the
    controller, ``mesh.devices[0]``, where the queries and answers are."""
    l_pac: int
    primary: int
    sa_intv: int
    occ_rows_per_shard: int
    sa_rows_per_shard: int
    L2: torch.Tensor           # pos_dtype[5], on the controller
    occ_fused: list            # per shard: int64[occ_rows_per_shard, 8]
    sa_samples: list           # per shard: pos_dtype[sa_rows_per_shard]
    ann_end: torch.Tensor      # pos_dtype[n_anns], on the controller
    mesh: Mesh

    def shard_bytes(self, i: int) -> int:
        """Bytes of the sharded arrays that shard i holds."""
        return sum(t.numel() * t.element_size()
                   for t in (self.occ_fused[i], self.sa_samples[i]))

    @staticmethod
    def from_device_index(didx: DeviceIndex, mesh: Mesh) -> "ShardedIndex":
        def split(a: torch.Tensor) -> list:
            R = -(-a.shape[0] // mesh.size)
            out = []
            for i, d in enumerate(mesh.devices):
                blk = a[i * R:(i + 1) * R]
                if blk.shape[0] < R:
                    blk = torch.cat([blk, blk.new_zeros(
                        (R - blk.shape[0],) + tuple(a.shape[1:]))])
                out.append(blk.to(d, copy=True))
            return out

        occ, sa = split(didx.occ_fused), split(didx.sa_samples)
        ctl = mesh.devices[0]
        return ShardedIndex(
            l_pac=didx.l_pac, primary=didx.primary, sa_intv=didx.sa_intv,
            occ_rows_per_shard=occ[0].shape[0],
            sa_rows_per_shard=sa[0].shape[0],
            L2=didx.L2.to(ctl), occ_fused=occ, sa_samples=sa,
            ann_end=didx.ann_end.to(ctl), mesh=mesh)


def _routed_rows(sidx: ShardedIndex, blocks: list,
                 want_row: torch.Tensor) -> torch.Tensor:
    """The routing core: global rows ``want_row`` (any shape) of the
    row-sharded array ``blocks``. Every shard gathers the rows it owns
    (int64 row ids, 0 where another shard owns the row); the disjoint
    answers are summed on the controller."""
    parts = []
    for i, (blk, d) in enumerate(zip(blocks, sidx.mesh.devices)):
        R = blk.shape[0]
        local = want_row.to(d).to(torch.int64) - i * R
        mine = (local >= 0) & (local < R)
        got = blk[local.clamp(0, R - 1)]
        if got.dim() > mine.dim():
            mine = mine[..., None]
        parts.append(torch.where(mine, got, 0))
    return psum(sidx.mesh, parts)


def occ4_all_sharded(sidx: ShardedIndex, k: torch.Tensor) -> torch.Tensor:
    """occ of all 4 bases at conceptual index k inclusive
    (``index.device.occ4_all``), one routed round."""
    n = stored_prefix(k, sidx.primary)
    r = occ_row_of(n)
    return occ4_from_row(_routed_rows(sidx, sidx.occ_fused, r), n - r * 64)


def inv_psi_sharded(sidx: ShardedIndex, k: torch.Tensor) -> torch.Tensor:
    """LF step on conceptual rank k (``index.device.inv_psi``), one routed
    round."""
    x = k - (k > sidx.primary).to(k.dtype)
    return inv_psi_from_row(sidx.L2, sidx.primary,
                            _routed_rows(sidx, sidx.occ_fused, x >> 6), k, x)


def occ1_sharded(sidx: ShardedIndex, k: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Count of base c in stored-BWT[0..k] inclusive, conceptual k
    (``index.device.occ1``), one routed round."""
    n = stored_prefix(k, sidx.primary)
    r = occ_row_of(n)
    return occ_from_row(_routed_rows(sidx, sidx.occ_fused, r), n - r * 64, c)


def backward_ext_sharded(sidx: ShardedIndex, k: torch.Tensor,
                         s: torch.Tensor, c: torch.Tensor):
    """Backward extension of interval (k, s) by base c
    (``index.device.backward_ext``) [bwa: bwt.c :: bwt_extend is_back=1] —
    the seeding hot loop's probe. Both occ queries ride one routed round."""
    occ = occ1_sharded(sidx, torch.stack([k - 1, k - 1 + s], dim=0),
                       torch.stack([c, c], dim=0))
    k2 = sidx.L2[c.to(torch.int64)] + 1 + occ[0]
    s2 = occ[1] - occ[0]
    return k2, s2


def sa_lookup_sharded(sidx: ShardedIndex, k: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Batched bwt_sa over the sharded index (``index.device.sa_lookup``):
    lockstep invPsi steps, one routed round and one ``.any()`` sync each,
    until no live lane is off a sampled rank, then one routed fetch from
    the sharded SA samples. Lanes where ``valid`` is false are not
    resolved."""
    mask = sidx.sa_intv - 1
    k = torch.where(valid, k, 0)
    steps = torch.zeros_like(k)
    live = valid
    while bool(live.any()):
        live = live & ((k & mask) != 0)
        k = torch.where(live, inv_psi_sharded(sidx, torch.where(live, k, 0)),
                        k)
        steps = steps + live.to(k.dtype)
    samp_row = k >> int(np.log2(sidx.sa_intv))
    return steps + _routed_rows(sidx, sidx.sa_samples, samp_row)


def run_sharded(mesh: Mesh, fn, sidx: ShardedIndex, *args):
    """fn(sidx, *args) with the query arguments moved to the controller:
    every shard sees every query (the rows are what is big)."""
    if sidx.mesh is not mesh:
        raise ValueError("run_sharded: the index is sharded over another "
                         "mesh")
    return fn(sidx, *(a.to(mesh.devices[0]) for a in args))
