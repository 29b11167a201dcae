"""Alignment options — the single source of truth for BWA-MEM-compatible parameters.

Mirrors the semantics of ``mem_opt_init`` / ``bwa_fill_scmat``
[bwa: bwamem.c :: mem_opt_init] [bwa: bwa.c :: bwa_fill_scmat]
(reference parity target per SURVEY.md §2.2; the reference mount was empty, so
defaults follow bwa-mem 0.7.x published behavior, which cloud-scale-bwamem
ports 1:1 — see SURVEY.md §0).

Algorithm options are a frozen dataclass, kept apart from runtime
configuration (device, caps) so that golden outputs never depend on where
the alignment runs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class MemOptions:
    """BWA-MEM alignment parameters with bwa-mem 0.7.x-identical defaults."""

    # Scoring
    a: int = 1              # match score          (-A)
    b: int = 4              # mismatch penalty     (-B)
    o_del: int = 6          # gap open, deletion   (-O)
    e_del: int = 1          # gap extend, deletion (-E)
    o_ins: int = 6          # gap open, insertion
    e_ins: int = 1          # gap extend, insertion
    pen_unpaired: int = 17  # phred-scaled penalty for unpaired read pair (-U)
    pen_clip5: int = 5      # 5'-end clipping penalty (-L)
    pen_clip3: int = 5      # 3'-end clipping penalty
    w: int = 100            # band width (-w)
    zdrop: int = 100        # Z-dropoff (-d)

    # Seeding
    min_seed_len: int = 19      # minimum SMEM length (-k)
    split_factor: float = 1.5   # split SMEMs longer than min_seed_len*split_factor (-r)
    split_width: int = 10       # re-seed a long SMEM only if occ <= split_width
    max_occ: int = 500          # skip SMEMs with more occurrences (-c)
    max_mem_intv: int = 0       # 3rd-round LAST-like seeding; 0 = off (bwa<=0.7.10)

    # Chaining
    max_chain_gap: int = 10000  # max gap to chain two seeds (-g)
    max_chain_extend: int = 1 << 30
    min_chain_weight: int = 0
    mask_level: float = 0.50    # chain/region overlap fraction considered redundant
    drop_ratio: float = 0.50    # drop a chain if weight < drop_ratio * best overlapping
    mask_level_redun: float = 0.95

    # Output / finishing
    T: int = 30                 # minimum score to output (-T)
    flag: int = 0               # MEM_F_* bit flags (PE/ALL/NOPAIRING/...)
    mapq_coef_len: float = 50.0
    max_ins: int = 10000        # max insert size for pestat
    max_matesw: int = 50        # max mate-rescue SW rounds per end
    max_xa_hits: int = 5        # max XA hits per record (-h)
    xa_drop_ratio: float = 0.80 # emit XA only if score >= ratio * primary score

    # --- derived, cached -------------------------------------------------
    @property
    def mapq_coef_fac(self) -> float:
        return math.log(self.mapq_coef_len)

    @property
    def split_len(self) -> int:
        """SMEMs longer than this are candidates for 2nd-round re-seeding."""
        return int(self.min_seed_len * self.split_factor + 0.499)

    @property
    def scmat(self) -> np.ndarray:
        """5x5 int8 score matrix over {A,C,G,T,N} [bwa: bwa.c :: bwa_fill_scmat]."""
        m = np.full((5, 5), -1, dtype=np.int8)
        for i in range(4):
            for j in range(4):
                m[i, j] = self.a if i == j else -self.b
        # row/col 4 (N) stay -1
        return m

    # Common flag bits, mirroring MEM_F_* [bwa: bwamem.h]
    F_PE = 0x2
    F_NOPAIRING = 0x4
    F_ALL = 0x8
    F_NO_MULTI = 0x10
    F_NO_RESCUE = 0x20
    F_SOFTCLIP = 0x200

    def replace(self, **kw) -> "MemOptions":
        return dataclasses.replace(self, **kw)
