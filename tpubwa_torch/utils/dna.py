"""DNA encoding utilities shared by the index builder, oracle, and device path.

Encoding: A=0, C=1, G=2, T=3, anything else (N/ambiguous)=4 — identical to
bwa's ``nst_nt4_table`` [bwa: bntseq.c :: nst_nt4_table].
"""
from __future__ import annotations

import numpy as np

_NT4 = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _NT4[ord(c)] = i
    _NT4[ord(c.lower())] = i

_NT_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0..4}."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _NT4[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _NT_CHARS[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.uint8)[::-1]]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack codes {0..3} into a uint8 array, 4 bases/byte, base i at bits
    ``(~i & 3) * 2`` (big-endian within byte, matching bwa's .pac layout
    [bwa: bntseq.c :: _set_pac])."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes & 3
    quads = padded.reshape(-1, 4)
    return (
        (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    ).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit`; returns the first ``n`` codes."""
    pac = np.asarray(pac, dtype=np.uint8)
    out = np.empty(len(pac) * 4, dtype=np.uint8)
    out[0::4] = (pac >> 6) & 3
    out[1::4] = (pac >> 4) & 3
    out[2::4] = (pac >> 2) & 3
    out[3::4] = pac & 3
    return out[:n]
