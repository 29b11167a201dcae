"""Contiguous text and query windows as (B, W) gathers.

Semantics match ``index.device.text_base`` ([bwa: bntseq.c :: _get_pac]
with the reverse strand reconstructed as 3 - pac[2*l_pac-1-pos]) for every
lane a caller consumes. Windows are cut from a fixed span of packed rows
around the start, and a lane past that span reads base 0, exactly as the
reference implementation's shifted-row formulation does, so callers that
mask by their own bounds see identical values everywhere.
"""
from __future__ import annotations

import torch

from ..index.device import DeviceIndex
from ..utils.profiling import synced


def _shift_mask(nb: int) -> int:
    """Shifts a binary-decomposed variable shift over nb lanes can express:
    the sum of the powers of two below nb."""
    m, bit = 0, 1
    while bit < nb:
        m |= bit
        bit <<= 1
    return m


def shift_left(x: torch.Tensor, s: torch.Tensor, W: int, fill,
               nb: int | None = None) -> torch.Tensor:
    """out[b, i] = x[b, s'[b] + i], `fill` past the end, where s' keeps the
    bits of s that a binary-decomposed shift over nb lanes (default: the
    row width) expresses — s' == s for every in-range shift."""
    B, NB = x.shape
    s = (s.to(torch.int64) & _shift_mask(NB if nb is None else nb))[:, None]
    j = s + torch.arange(W, dtype=torch.int64, device=x.device)[None, :]
    out = x.gather(1, j.clamp(max=NB - 1)) if NB else \
        torch.full((B, W), fill, dtype=x.dtype, device=x.device)
    with synced():      # the fill's copy to the device blocks the host
        fill = torch.as_tensor(fill, dtype=x.dtype, device=x.device)
    return torch.where(j < NB, out, fill)


def _window_from_pac(didx: DeviceIndex, a_base: torch.Tensor,
                     r0: torch.Tensor, W: int, NROW: int,
                     backward: torch.Tensor) -> torch.Tensor:
    """out[b, j] = pac_base(a_base[b] +- j) over the fetched span of NROW
    rows starting at row r0 (0 outside the span); backward selects -j."""
    n_prow = didx.pac_rows.shape[0]
    NB = NROW * 128
    a = (a_base - (r0 << 7)).clamp(0, NB - 1).to(torch.int64)
    j = torch.arange(W, dtype=torch.int64, device=a.device)[None, :]
    p = torch.where(backward[:, None], a[:, None] - j, a[:, None] + j)
    ok = (p >= 0) & (p < NB)
    p = p.clamp(0, NB - 1)
    row = (r0.to(torch.int64)[:, None] + (p >> 7)).clamp(0, n_prow - 1)
    word = didx.pac_rows[row, (p >> 4) & 7]
    t = p & 15
    # byte t>>2 (little-endian in the word), base t&3 at bits 2*(3-(t&3))
    base = (word >> (8 * (t >> 2) + 2 * (3 - (t & 3)))) & 3
    return torch.where(ok, base, 0).to(torch.int32)


def text_window_asc(didx: DeviceIndex, start: torch.Tensor,
                    W: int) -> torch.Tensor:
    """out[b, j] = text(start[b] + j), j in [0, W). Per-row strand from
    start; lanes crossing the strand boundary are caller-masked."""
    l_pac = didx.l_pac
    rev = start >= l_pac
    a0 = torch.where(rev, 2 * l_pac - 1 - start, start)
    a0c = a0.clamp(0, l_pac - 1)
    NROW = W // 128 + 2
    r0 = torch.where(rev, (a0c - (W - 1)).clamp(0, l_pac) >> 7, a0c >> 7)
    out = _window_from_pac(didx, a0c, r0, W, NROW, rev)
    return torch.where(rev[:, None], 3 - out, out)


def text_window_desc(didx: DeviceIndex, end: torch.Tensor,
                     W: int) -> torch.Tensor:
    """out[b, j] = text(end[b] - 1 - j), j in [0, W)."""
    l_pac = didx.l_pac
    e1 = end - 1
    rev = e1 >= l_pac
    a0 = torch.where(rev, 2 * l_pac - 1 - e1, e1)
    a0c = a0.clamp(0, l_pac - 1)
    NROW = W // 128 + 2
    r0 = torch.where(rev, a0c >> 7, (a0c - (W - 1)).clamp(0, l_pac) >> 7)
    out = _window_from_pac(didx, a0c, r0, W, NROW, ~rev)
    return torch.where(rev[:, None], 3 - out, out)


def slice_rows(flat: torch.Tensor, starts: torch.Tensor, S: int,
               fill=0) -> torch.Tensor:
    """out[b, j] = flat[starts[b] + j], j in [0, S); `fill` past the end."""
    D = flat.shape[0]
    s0 = starts.clamp(0, D).to(torch.int64)[:, None]
    j = s0 + torch.arange(S, dtype=torch.int64, device=flat.device)[None, :]
    src = flat[j.clamp(max=max(D - 1, 0))] if D else \
        torch.full(j.shape, fill, dtype=flat.dtype, device=flat.device)
    with synced():      # the fill's copy to the device blocks the host
        fill = torch.as_tensor(fill, dtype=flat.dtype, device=flat.device)
    return torch.where(j < D, src, fill)


def query_window_asc(seqs: torch.Tensor, start: torch.Tensor,
                     W: int) -> torch.Tensor:
    """out[b, j] = seqs[b, start[b] + j] (0-fill past L)."""
    L = seqs.shape[1]
    return shift_left(seqs, start.clamp(0, L), W, 0, nb=L + max(W - 1, 1))


def query_window_desc(seqs: torch.Tensor, end: torch.Tensor,
                      W: int) -> torch.Tensor:
    """out[b, j] = seqs[b, end[b] - 1 - j] (0-fill before 0)."""
    L = seqs.shape[1]
    return shift_left(seqs.flip(1), (L - end).clamp(0, L), W, 0,
                      nb=L + max(W - 1, 1))
