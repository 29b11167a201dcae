"""FM-index construction — replacement for the external ``bwa index`` step the
reference depended on (SURVEY.md §2.4: CS-BWAMEM consumes stock ``bwa index``
output; we build our own, with an occ/checkpoint layout designed for
vectorised gathers). The ``.npz`` written by :meth:`FMIndex.save` is the
repository's one index format, shared with the reference package.

Semantics mirror [bwa: bwtindex.c] / [bwa: bntseq.c :: bns_fasta2bntseq]:
  * text = forward genome ++ reverse-complement (length 2*l_pac)
  * conceptual BWT over text+$ has 2L+1 rows; the $ row (``primary``) is
    dropped from the stored BWT, occ queries shift indices past it
    [bwa: bwt.c :: bwt_occ]
  * SA sampled every ``sa_intv`` conceptual ranks; ``samples[0]`` stores -1 so
    the invPsi walk arithmetic works when crossing the sentinel
    [bwa: bwt.c :: bwt_cal_sa, bwt_sa]
  * ambiguous (N) bases are replaced by deterministic pseudo-random bases and
    recorded as "holes" [bwa: bntseq.c :: bns_fasta2bntseq]

Device layout (differs from .bwt on purpose — designed for vectorized gathers):
  * ``bwt_words``: uint32, 16 bases/word, base j at bits ``2*(j%16)``
  * ``occ_cp``:    uint32[n_cp, 4], checkpoint every OCC_INTERVAL=64 bases
    (= 4 words), counts of each base in stored-BWT[0..64*i)
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..utils import dna

OCC_INTERVAL = 64       # bases per occ checkpoint (4 uint32 words)
BASES_PER_WORD = 16
DEFAULT_SA_INTV = 4   # denser than bwa (32): HBM is plentiful, invPsi walks are latency-bound
BIG_SA_INTV = 32      # human-scale: samples must fit HBM (6.2e9/32*8B = 1.5GB)
_CHUNK = 1 << 26      # elements per host-side construction chunk


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of ``text`` (codes, implicit terminal $ < everything)
    via the native linear-time SA-IS (native/sais.cpp): int64[n], the ranks
    of the n non-empty suffixes (the $-only suffix, always first, is
    excluded)."""
    n = len(text)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    from ..oracle import get_lib
    sa = np.empty(n + 1, dtype=np.int64)  # +1 scratch slot (sentinel)
    get_lib().tb_sais(np.ascontiguousarray(text, dtype=np.uint8), n, sa)
    return sa[:n]


@dataclasses.dataclass
class Annotation:
    """Per-sequence annotation, the .ann analog [bwa: bntseq.h :: bntann1_t]."""
    name: str
    offset: int
    length: int


@dataclasses.dataclass
class FMIndex:
    """Full alignment index held as flat host numpy arrays; the device
    tensors are built from it by :meth:`index.device.DeviceIndex.from_host`."""

    l_pac: int                 # forward genome length; text length = 2*l_pac
    primary: int               # conceptual rank of the sentinel row
    L2: np.ndarray             # int64[5]: L2[c] = #symbols < c in text (rank base)
    bwt_words: np.ndarray      # uint32[ceil(2L/16)] packed stored-BWT
    occ_cp: np.ndarray         # uint32[n_cp, 4] checkpoint counts
    sa_samples: np.ndarray     # int64[ceil((2L+1)/sa_intv)] sampled SA'
    sa_intv: int
    pac: np.ndarray            # uint8 2-bit packed forward genome
    anns: list[Annotation]
    ambs: np.ndarray           # int64[n_amb, 2]: (offset, len) N-runs

    # ---- reference sequence access [bwa: bntseq.c :: bns_get_seq] ----
    def get_base(self, pos: int) -> int:
        """Base of the *bidirectional* text at pos in [0, 2*l_pac)."""
        return int(self.get_seq(pos, pos + 1)[0])

    def pac_base(self, pos: int) -> int:
        """Base of the forward genome at pos in [0, l_pac), from the 2-bit
        packed ``pac`` (base j in bits 6 - 2*(j % 4) of byte j // 4)."""
        byte = self.pac[pos >> 2]
        return (byte >> ((~pos & 3) << 1)) & 3

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Text slice [beg, end) of the bidirectional genome, vectorized."""
        beg, end = int(beg), int(end)
        pos = np.arange(beg, end, dtype=np.int64)
        fwd = pos < self.l_pac
        p = np.where(fwd, pos, 2 * self.l_pac - 1 - pos)
        byte = self.pac[p >> 2]
        base = (byte >> (((~p & 3) << 1)).astype(np.uint8)) & 3
        return np.where(fwd, base, 3 - base).astype(np.uint8)

    def pos2rid(self, pos: int) -> int:
        """Forward-coordinate position -> sequence id, -1 past the last
        sequence [bwa: bntseq.c :: bns_pos2rid]."""
        offs = np.array([a.offset for a in self.anns], dtype=np.int64)
        ends = offs + np.array([a.length for a in self.anns], dtype=np.int64)
        if pos >= ends[-1]:
            return -1
        return int(np.searchsorted(ends, pos, side="right"))

    # ---- persistence ----
    def save(self, path: str | Path) -> None:
        total = (self.bwt_words.nbytes + self.occ_cp.nbytes
                 + self.sa_samples.nbytes + self.pac.nbytes)
        # compressing multi-GB indices costs minutes for little gain
        savez = np.savez_compressed if total < (1 << 30) else np.savez
        savez(
            path,
            l_pac=self.l_pac,
            primary=self.primary,
            L2=self.L2,
            bwt_words=self.bwt_words,
            occ_cp=self.occ_cp,
            sa_samples=self.sa_samples,
            sa_intv=self.sa_intv,
            pac=self.pac,
            ann_names=np.array([a.name for a in self.anns]),
            ann_offsets=np.array([a.offset for a in self.anns], dtype=np.int64),
            ann_lengths=np.array([a.length for a in self.anns], dtype=np.int64),
            ambs=self.ambs,
        )

    @staticmethod
    def load(path: str | Path) -> "FMIndex":
        z = np.load(str(path), allow_pickle=False)
        anns = [
            Annotation(str(n), int(o), int(l))
            for n, o, l in zip(z["ann_names"], z["ann_offsets"], z["ann_lengths"])
        ]
        return FMIndex.from_arrays(z, anns)

    @staticmethod
    def from_arrays(d, anns) -> "FMIndex":
        """Build from a mapping of host arrays (the ``.npz`` fields, or the
        attributes of another package's index) and annotations given as
        :class:`Annotation` or ``(name, offset, length)`` tuples."""
        return FMIndex(
            l_pac=int(d["l_pac"]),
            primary=int(d["primary"]),
            L2=np.asarray(d["L2"]),
            bwt_words=np.asarray(d["bwt_words"]),
            occ_cp=np.asarray(d["occ_cp"]),
            sa_samples=np.asarray(d["sa_samples"]),
            sa_intv=int(d["sa_intv"]),
            pac=np.asarray(d["pac"]),
            anns=[a if isinstance(a, Annotation) else Annotation(*a)
                  for a in anns],
            ambs=np.asarray(d["ambs"]),
        )


def build_index(
    sequences: list[tuple[str, str]],
    sa_intv: int | None = None,
    amb_seed: int = 11,
) -> FMIndex:
    """Build the full FM-index from [(name, sequence)] FASTA records.

    Every post-SA step is CHUNKED (bounded temporaries) so human-scale
    genomes build within host RAM: at 3.1 Gbp forward (6.2e9 text) the
    peak is the SA-IS stage itself (~8 bytes/char in native/sais.cpp),
    not the numpy plumbing around it.
    """
    anns: list[Annotation] = []
    codes_parts: list[np.ndarray] = []
    amb_list: list[tuple[int, int]] = []
    offset = 0
    rng = np.random.default_rng(amb_seed)
    for name, seq in sequences:
        c = dna.encode(seq) if isinstance(seq, (str, bytes)) \
            else np.asarray(seq, dtype=np.uint8)
        ambn = c == 4
        if ambn.any():
            # record N runs, then substitute deterministic random bases
            idx = np.flatnonzero(ambn)
            run_starts = idx[np.r_[True, np.diff(idx) > 1]]
            run_ends = idx[np.r_[np.diff(idx) > 1, True]]
            for s, e in zip(run_starts, run_ends):
                amb_list.append((offset + int(s), int(e - s + 1)))
            c = c.copy()
            c[ambn] = rng.integers(0, 4, size=int(ambn.sum()), dtype=np.uint8)
        anns.append(Annotation(name=name, offset=offset, length=len(c)))
        codes_parts.append(c)
        offset += len(c)

    fwd = np.concatenate(codes_parts) if codes_parts else np.empty(0, np.uint8)
    del codes_parts
    l_pac = len(fwd)
    text = np.concatenate([fwd, dna.revcomp(fwd)])
    n = len(text)  # 2 * l_pac
    if sa_intv is None:
        sa_intv = DEFAULT_SA_INTV if n < 2**31 else BIG_SA_INTV

    sa = suffix_array(text)

    # primary: conceptual rank (in the 2L+1-row matrix) of suffix starting at 0
    primary = -1
    for i in range(0, n, _CHUNK):
        hits = np.flatnonzero(sa[i:i + _CHUNK] == 0)
        if hits.size:
            primary = i + int(hits[0]) + 1
            break

    # stored BWT (sentinel row dropped): row0 = text[-1]; rows for sa[j] != 0
    bwt = np.empty(n, dtype=np.uint8)
    bwt[0] = text[-1]
    out = 1
    for i in range(0, n, _CHUNK):
        ch = sa[i:i + _CHUNK]
        v = ch[ch != 0]
        bwt[out:out + len(v)] = text[v - 1]
        out += len(v)

    # sampled SA over conceptual ranks: SA'[0]=$ -> -1, SA'[i+1] = sa[i]
    n_samp = (n + 1 + sa_intv - 1) // sa_intv
    sa_samples = np.empty(n_samp, dtype=np.int64)
    sa_samples[0] = -1  # sentinel row; bwt_sa arithmetic relies on this
    if n_samp > 1:
        sa_samples[1:] = sa[np.arange(1, n_samp, dtype=np.int64) * sa_intv - 1]
    del sa, text  # free ~9 bytes/char before the occ/words passes

    # L2: cumulative symbol counts (the BWT is a permutation of the text)
    counts = np.zeros(4, dtype=np.int64)
    for i in range(0, n, _CHUNK):
        counts += np.bincount(bwt[i:i + _CHUNK], minlength=4)[:4]
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts)
    if counts.max(initial=0) >= 2**31:
        raise NotImplementedError(
            "per-base occurrence counts exceed int32 checkpoints")

    # occ checkpoints + packed words, chunked at block granularity
    n_blk = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_cp = n_blk + 1
    occ_cp = np.zeros((n_cp, 4), dtype=np.uint32)
    n_words = n_blk * (OCC_INTERVAL // BASES_PER_WORD)
    words = np.empty(n_words, dtype=np.uint32)
    shifts = 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)
    run = np.zeros(4, dtype=np.int64)
    blk_per_chunk = max(_CHUNK // OCC_INTERVAL, 1)
    for b0 in range(0, n_blk, blk_per_chunk):
        b1 = min(b0 + blk_per_chunk, n_blk)
        seg = np.full((b1 - b0) * OCC_INTERVAL, 4, dtype=np.uint8)
        hi = min(b1 * OCC_INTERVAL, n)
        seg[: hi - b0 * OCC_INTERVAL] = bwt[b0 * OCC_INTERVAL: hi]
        # per-block counts: padding (code 4) matches none of 0..3
        oneh = (seg.reshape(-1, OCC_INTERVAL)[:, :, None]
                == np.arange(4, dtype=np.uint8)).sum(axis=1, dtype=np.int64)
        occ_cp[b0 + 1: b1 + 1] = (run + np.cumsum(oneh, axis=0)
                                  ).astype(np.uint32)
        run = run + oneh.sum(axis=0)
        w0 = b0 * (OCC_INTERVAL // BASES_PER_WORD)
        seg[seg > 3] = 0  # packed padding bases are A; queries clamp to n
        words[w0: w0 + (b1 - b0) * 4] = (
            seg.reshape(-1, BASES_PER_WORD).astype(np.uint32)
            << shifts[None, :]).sum(axis=1, dtype=np.uint32)

    ambs = (
        np.array(amb_list, dtype=np.int64).reshape(-1, 2)
        if amb_list
        else np.empty((0, 2), dtype=np.int64)
    )

    return FMIndex(
        l_pac=l_pac,
        primary=primary,
        L2=L2,
        bwt_words=words,
        occ_cp=occ_cp,
        sa_samples=sa_samples,
        sa_intv=sa_intv,
        pac=dna.pack_2bit(fwd),
        anns=anns,
        ambs=ambs,
    )
