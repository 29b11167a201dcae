"""Device-resident FM-index: torch tensors + vectorised occ primitives.

One copy of the index per device, the analog of the reference's broadcast
``BWAIdxType`` (SURVEY.md §1 L3). Coordinate width scales with the genome
(``pos_dtype``): int32 while 2*l_pac < 2**31, int64 beyond — GRCh38's
bidirectional text is ~6.2e9, so ranks/positions need 33 bits. Per-base
occurrence COUNTS stay int32 on every genome a device can hold (count of
one base <= text/2 < 2**31 — guarded at build time).

Packed words. The occ checkpoints and the BWT words of their 64-base block
are FUSED into one row (``occ_fused[cp, 0:4]`` = counts, ``[4:8]`` = packed
2-bit bases), so every occ query and every invPsi step reads one row. The
words are unsigned 32-bit values that get shifted, and torch's uint32 has
no shifts or comparisons, so they are held as int64 (values in [0, 2**32)).
Semantics identical to [bwa: bwt.c :: bwt_occ, bwt_invPsi].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import host_any
from .builder import FMIndex

M32 = 0xFFFFFFFF


@dataclasses.dataclass
class DeviceIndex:
    l_pac: int
    primary: int
    sa_intv: int
    L2: torch.Tensor           # pos_dtype[5]
    occ_fused: torch.Tensor    # int64[n_cp, 8]: cp counts + block words
    sa_samples: torch.Tensor   # pos_dtype[n_samp]
    pac: torch.Tensor          # uint8[ceil(l_pac/4)]
    pac_rows: torch.Tensor     # int64[n_prow, 8]: pac as 32-bit words, 8 per
    #                            row (128 bases/row)
    ann_end: torch.Tensor      # pos_dtype[n_anns]: offset+length per sequence

    @property
    def pos_dtype(self) -> torch.dtype:
        """Width of text positions / FM ranks for this index."""
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self.L2.device

    def to(self, device) -> "DeviceIndex":
        """This index on ``device``: itself where it lies there already,
        else a copy with every tensor moved."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @staticmethod
    def from_host(idx: FMIndex, device) -> "DeviceIndex":
        if int(idx.occ_cp.max(initial=0)) >= 2**31:
            raise NotImplementedError(
                "per-base occurrence counts exceed int32; genomes this "
                "skewed need the sharded-index mode")
        pos_dtype = torch.int64 if 2 * idx.l_pac >= 2**31 else torch.int32
        n_cp = idx.occ_cp.shape[0]
        words = np.zeros(n_cp * 4, dtype=np.uint32)
        words[: len(idx.bwt_words)] = idx.bwt_words
        fused = np.concatenate(
            [idx.occ_cp.astype(np.uint32), words.reshape(n_cp, 4)],
            axis=1).astype(np.int64)
        n_prow = -(-int(idx.pac.shape[0]) // 32) + 1   # +1 pad row
        pac_pad = np.zeros(n_prow * 32, dtype=np.uint8)
        pac_pad[: idx.pac.shape[0]] = idx.pac
        pac_rows = pac_pad.view("<u4").reshape(n_prow, 8).astype(np.int64)
        dev = torch.device(device)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a)).to(
            device=dev, dtype=dt)
        return DeviceIndex(
            l_pac=int(idx.l_pac),
            primary=int(idx.primary),
            sa_intv=int(idx.sa_intv),
            L2=t(idx.L2, pos_dtype),
            occ_fused=t(fused, torch.int64),
            sa_samples=t(idx.sa_samples, pos_dtype),
            pac=t(idx.pac, torch.uint8),
            pac_rows=t(pac_rows, torch.int64),
            ann_end=t(np.array([a.offset + a.length for a in idx.anns],
                               dtype=np.int64), pos_dtype),
        )


def sel4(arr: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """arr[..., c] for c in {0..3} as a 4-way select (0 for other c).
    arr: (..., 4); c: (...). Keeps arr's dtype."""
    return (torch.where(c == 0, arr[..., 0], 0)
            + torch.where(c == 1, arr[..., 1], 0)
            + torch.where(c == 2, arr[..., 2], 0)
            + torch.where(c == 3, arr[..., 3], 0))


def sel_vec(vec: torch.Tensor, c: torch.Tensor, n: int) -> torch.Tensor:
    """vec[c] for a tiny vec (e.g. L2[5]) and c in [0, n) as an n-way
    select (0 for other c). Keeps vec's dtype (L2 is pos_dtype)."""
    out = torch.zeros(c.shape, dtype=vec.dtype, device=vec.device)
    for i in range(n):
        out = torch.where(c == i, vec[i], out)
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held in int64 lanes -> int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def _eq_bits(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Per-2-bit-slot equality mask: bit 2*j set iff slot j == c."""
    x = words ^ (c.to(torch.int64) * 0x55555555)
    neq = (x | (x >> 1)) & 0x55555555
    return neq ^ 0x55555555


def _count_first(words: torch.Tensor, c: torch.Tensor,
                 m: torch.Tensor) -> torch.Tensor:
    """Count of base c in the first m (0..64) bases of a 4-word block.

    words: (..., 4) int64 words; c: (...); m: (...).
    """
    eq = _eq_bits(words, c[..., None])
    off = torch.arange(4, dtype=torch.int64, device=m.device) * 16
    valid = (m[..., None].to(torch.int64) - off).clamp(0, 16)
    mask = torch.where(valid >= 16, M32, (1 << (2 * valid)) - 1)
    return _popcount32(eq & mask).sum(dim=-1, dtype=torch.int32)


def _row_cp(row: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Checkpoint count for base c from a fused row (..., 8) -> int32."""
    return row[..., 0:4].gather(-1, c.to(torch.int64)[..., None])[..., 0] \
        .to(torch.int32)


def stored_prefix(k: torch.Tensor, primary: int) -> torch.Tensor:
    """Length n of the stored-BWT prefix [0, n) that conceptual index k
    covers inclusively (the $ row is not stored) [bwa: bwt_occ]."""
    n = torch.where(k < 0, 0, k + 1 - (k >= primary).to(k.dtype))
    return n.clamp(min=0)


def occ_row_of(n: torch.Tensor) -> torch.Tensor:
    """Fused row whose checkpoint + block counts the prefix [0, n)."""
    return (n - 1).clamp(min=0) >> 6


def occ_from_row(row: torch.Tensor, m: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Count of base c in a fused row's checkpoint plus the first m (0..64)
    bases of its block -> int32."""
    return _row_cp(row, c) + _count_first(row[..., 4:8], c,
                                          m.to(torch.int32))


def occ4_from_row(row: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """occ_from_row for all 4 bases -> (..., 4) int32: four popcount passes
    over the same row [bwa: bwt_2occ4]."""
    m = m.to(torch.int32)
    words = row[..., 4:8]
    cnts = torch.stack(
        [_count_first(words, torch.full_like(m, c), m) for c in range(4)],
        dim=-1)
    return row[..., 0:4].to(torch.int32) + cnts


def occ_prefix(didx: DeviceIndex, n: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """#occurrences of base c in stored-BWT[0, n). ONE fused-row gather.
    Returns int32 (counts < 2**31 by the build-time guard)."""
    r = occ_row_of(n)
    return occ_from_row(didx.occ_fused[r.to(torch.int64)], n - r * 64, c)


def occ4_all(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """occ of all 4 bases at conceptual index k inclusive — ONE gather,
    four popcount passes over the same fused row [bwa: bwt_2occ4]."""
    n = stored_prefix(k, didx.primary)
    r = occ_row_of(n)
    return occ4_from_row(didx.occ_fused[r.to(torch.int64)], n - r * 64)


def occ1(didx: DeviceIndex, k: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """bwa bwt_occ: count of c in stored-BWT[0..k] inclusive, conceptual k."""
    return occ_prefix(didx, stored_prefix(k, didx.primary), c)


def _word_base(row: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stored-BWT base at index x from its fused row -> int32 code."""
    word = row[..., 4:8].gather(-1, ((x >> 4) & 3).to(torch.int64)[..., None])
    return ((word[..., 0] >> (2 * (x & 15)).to(torch.int64)) & 3) \
        .to(torch.int32)


def bwt_base(didx: DeviceIndex, j: torch.Tensor) -> torch.Tensor:
    """Stored-BWT base at position j (any int dtype) -> int32 code."""
    return _word_base(didx.occ_fused[(j >> 6).to(torch.int64)], j)


def backward_ext(didx: DeviceIndex, k: torch.Tensor, s: torch.Tensor,
                 c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward extension of interval (k, s) by base c (k-side only)
    [bwa: bwt.c :: bwt_extend is_back=1, single base]."""
    occ = occ1(didx, torch.stack([k - 1, k - 1 + s], dim=0),
               torch.stack([c, c], dim=0))
    k2 = didx.L2[c.to(torch.int64)] + 1 + occ[0]
    s2 = occ[1] - occ[0]
    return k2, s2


def inv_psi_from_row(L2: torch.Tensor, primary: int, row: torch.Tensor,
                     k: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """LF step on conceptual rank k from the fused row x >> 6 of its stored
    index x = k - (k > primary): the BWT base at x and its occ count both
    come from that row."""
    c = _word_base(row, x)
    cnt = _row_cp(row, c) + _count_first(row[..., 4:8], c,
                                         ((x & 63) + 1).to(torch.int32))
    res = L2[c.to(torch.int64)] + cnt
    return torch.where(k == primary, 0, res).to(k.dtype)


def inv_psi(didx: DeviceIndex, k: torch.Tensor) -> torch.Tensor:
    """LF step on conceptual rank [bwa: bwt.c :: bwt_invPsi] — one gather."""
    x = k - (k > didx.primary).to(k.dtype)
    return inv_psi_from_row(didx.L2, didx.primary,
                            didx.occ_fused[(x >> 6).to(torch.int64)], k, x)


def sa_lookup(didx: DeviceIndex, k: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Batched bwt_sa: walk invPsi until a sampled rank [bwa: bwt.c ::
    bwt_sa]. Lockstep until every live lane hits a sampled rank; one host
    sync per two invPsi steps."""
    mask = didx.sa_intv - 1

    def body(k, steps, live):
        live = live & ((k & mask) != 0)
        k2 = torch.where(live, inv_psi(didx, torch.where(live, k, 0)), k)
        return k2, steps + live.to(k.dtype), live

    k = torch.where(valid, k, 0)
    steps = torch.zeros_like(k)
    live = valid
    while True:
        k, steps, live = body(*body(k, steps, live))
        if not host_any(live):
            break
    shift = int(np.log2(didx.sa_intv))
    return steps + didx.sa_samples[(k >> shift).to(torch.int64)]


def text_base(didx: DeviceIndex, pos: torch.Tensor) -> torch.Tensor:
    """Base of the bidirectional text at pos [bwa: bntseq.c :: _get_pac]."""
    fwd = pos < didx.l_pac
    p = torch.where(fwd, pos, 2 * didx.l_pac - 1 - pos)
    byte = didx.pac[(p >> 2).to(torch.int64)].to(torch.int32)
    b = (byte >> ((~p & 3) << 1).to(torch.int32)) & 3
    return torch.where(fwd, b, 3 - b)
