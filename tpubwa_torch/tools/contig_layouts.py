"""Named contig layouts that the port is held to beyond one sequence: a
text of ``l_pac`` bases cut into the sequence count and order of a human
reference, used by the contigs tests and ``chip_smoke.py contigs``.

``grch38`` has the 195 sequences of the GRC's no-alt analysis set
(GCA_000001405.15_GRCh38_no_alt_analysis_set): ``chr1`` ... ``chr22``,
``chrX``, ``chrY`` take 80% of the text in proportion to their GRCh38
lengths, and 171 others (``chrUn_<i>``) share the last 20% equally.
``hs38dh`` has bwa.kit's 3366: those 195 over the first 70% of the text,
then 261 ``alt_<i>``, 2385 ``decoy_<i>`` and 525 ``HLA_<i>`` sharing the
last 30% equally. ALT contigs are plain contigs here, as in both packages.

The lengths sum to ``l_pac`` exactly; within a group they are rounded down
and the group's remainder goes to its last contig; every contig is at
least 1 bp. At a few Mbp the contigs are far shorter than GRCh38's (a
boundary every 23.6 kbp against every 16 Mbp), so a layout here stresses
the contig boundaries rather than giving GRCh38's rates.
"""
from __future__ import annotations

# GRCh38 chromosome lengths in bp (GRC, GCA_000001405.15), used only as
# proportions
GRCH38_LENGTHS = (
    ("chr1", 248956422), ("chr2", 242193529), ("chr3", 198295559),
    ("chr4", 190214555), ("chr5", 181538259), ("chr6", 170805979),
    ("chr7", 159345973), ("chr8", 145138636), ("chr9", 138394717),
    ("chr10", 133797422), ("chr11", 135086622), ("chr12", 133275309),
    ("chr13", 114364328), ("chr14", 107043718), ("chr15", 101991189),
    ("chr16", 90338345), ("chr17", 83257441), ("chr18", 80373285),
    ("chr19", 58617616), ("chr20", 64444167), ("chr21", 46709983),
    ("chr22", 50818468), ("chrX", 156040895), ("chrY", 57227415),
)
N_UNPLACED = 171                      # no-alt set: 195 - 24
HS38DH_TAIL = (("alt", 261), ("decoy", 2385), ("HLA", 525))

# name -> (share of the text for the no-alt part, in tenths; tail groups)
LAYOUTS = {
    "grch38": (10, ()),
    "hs38dh": (7, HS38DH_TAIL),
}
NAMES = tuple(LAYOUTS)
COUNTS = {"grch38": len(GRCH38_LENGTHS) + N_UNPLACED,
          "hs38dh": len(GRCH38_LENGTHS) + N_UNPLACED
          + sum(n for _, n in HS38DH_TAIL)}


def _split(total: int, weights) -> list:
    """``total`` cut in proportion to ``weights``, rounded down, the
    remainder to the last part."""
    s = sum(weights)
    out = [total * w // s for w in weights]
    out[-1] += total - sum(out)
    return out


def _no_alt(total: int) -> list:
    """(name, length) of the no-alt analysis set over ``total`` bases."""
    chrom = total * 8 // 10
    lens = _split(chrom, [n for _, n in GRCH38_LENGTHS]) + \
        _split(total - chrom, [1] * N_UNPLACED)
    names = [n for n, _ in GRCH38_LENGTHS] + \
        [f"chrUn_{i}" for i in range(N_UNPLACED)]
    return list(zip(names, lens))


def layout(l_pac: int, name: str) -> list:
    """[(name, offset, length)] of layout ``name`` over a text of
    ``l_pac`` bases, in the layout's order."""
    tenths, tail = LAYOUTS[name]
    head = l_pac * tenths // 10
    seqs = _no_alt(head)
    if tail:
        names = [f"{g}_{i}" for g, n in tail for i in range(n)]
        seqs += list(zip(names, _split(l_pac - head, [1] * len(names))))
    out, off = [], 0
    for nm, ln in seqs:
        if ln < 1:
            raise ValueError(f"layout {name} over {l_pac} bases leaves "
                             f"{nm} empty")
        out.append((nm, off, ln))
        off += ln
    return out


def reannotate(idx, name: str):
    """``idx`` (an FMIndex) with layout ``name``'s annotations over its
    text: on a text without N runs, the index that ``build_index`` makes
    from the same text cut into the layout's FASTA records."""
    from ..index.builder import FMIndex
    return FMIndex.from_arrays(vars(idx), layout(idx.l_pac, name))


def ends(anns) -> list:
    """The contig boundaries (offset + length) of ``anns``, the last
    (the text's end) left out; ``anns`` as (name, offset, length) or
    Annotation."""
    return [_ol(a)[0] + _ol(a)[1] for a in anns][:-1]


def _ol(a) -> tuple:
    return (a.offset, a.length) if hasattr(a, "offset") else (a[1], a[2])


def _rec(name: str, codes):
    from ..io import fastx
    from ..utils import dna
    return fastx.FastxRecord(name, dna.decode(codes))


def straddlers(fwd, anns, every: int = 1, overs=(30, 50, 70),
               read_len: int = 100) -> list:
    """Reads of ``read_len`` that cross every ``every``-th contig
    boundary ``over`` bases past it, each also reverse-complemented."""
    from ..utils import dna
    recs = []
    for k, b in enumerate(ends(anns)[::every]):
        for over in overs:
            lo = b + over - read_len
            if lo < 0 or b + over > len(fwd):
                continue
            r = fwd[lo:b + over]
            recs += [_rec(f"strad_{k}_{over}_f", r),
                     _rec(f"strad_{k}_{over}_r", dna.revcomp(r))]
    return recs


def flush_reads(fwd, anns, n: int, read_len: int = 100) -> list:
    """Reads flush with the start and with the end of ``n`` contigs long
    enough to hold one, evenly spaced over the layout."""
    fit = [_ol(a) for a in anns if _ol(a)[1] >= read_len]
    pick = fit[::max(len(fit) // n, 1)][:n]
    recs = []
    for k, (off, ln) in enumerate(pick):
        recs += [_rec(f"flush_{k}_start", fwd[off:off + read_len]),
                 _rec(f"flush_{k}_end", fwd[off + ln - read_len:off + ln])]
    return recs


def chimeras(fwd, anns, n: int, seed: int, head: int = 130,
             tail: int = 120) -> list:
    """n reads of ``head`` bases from one contig and ``tail`` from
    another, the second part reverse-complemented in every other read."""
    import numpy as np
    from ..utils import dna
    rng = np.random.default_rng(seed)
    fit = [_ol(a) for a in anns if _ol(a)[1] >= head]
    recs = []
    for i in range(n):
        c1, c2 = rng.choice(len(fit), 2, replace=False)
        (o1, l1), (o2, l2) = fit[c1], fit[c2]
        p1 = o1 + int(rng.integers(0, l1 - head + 1))
        p2 = o2 + int(rng.integers(0, l2 - tail + 1))
        second = fwd[p2:p2 + tail]
        if i % 2:
            second = dna.revcomp(second)
        recs.append(_rec(f"chim_{i}_{c1}_{c2}", np.concatenate(
            [fwd[p1:p1 + head], second])))
    return recs


def boundary_pairs(fwd, anns, every: int, insert: int,
                   read_len: int) -> list:
    """Pairs (interleaved, FR) whose fragment of ``insert`` bases is
    centred on every ``every``-th contig boundary."""
    from ..utils import dna
    recs = []
    for k, b in enumerate(ends(anns)[::every]):
        lo = b - insert // 2
        if lo < 0 or lo + insert > len(fwd):
            continue
        frag = fwd[lo:lo + insert]
        recs += [_rec(f"bfrag_{k}", frag[:read_len]),
                 _rec(f"bfrag_{k}", dna.revcomp(frag[-read_len:]))]
    return recs


def split_pairs(fwd, anns, n: int, seed: int, read_len: int) -> list:
    """n pairs whose mates lie on two different contigs (first mate
    forward, second reverse-complemented)."""
    import numpy as np
    from ..utils import dna
    rng = np.random.default_rng(seed)
    fit = [_ol(a) for a in anns if _ol(a)[1] >= read_len]
    recs = []
    for i in range(n):
        c1, c2 = rng.choice(len(fit), 2, replace=False)
        (o1, l1), (o2, l2) = fit[c1], fit[c2]
        p1 = o1 + int(rng.integers(0, l1 - read_len + 1))
        p2 = o2 + int(rng.integers(0, l2 - read_len + 1))
        recs += [_rec(f"split_{i}_{c1}_{c2}", fwd[p1:p1 + read_len]),
                 _rec(f"split_{i}_{c1}_{c2}",
                      dna.revcomp(fwd[p2:p2 + read_len]))]
    return recs


def end_rescue_pairs(fwd, anns, n: int, seed: int, insert: int,
                     read_len: int, gap: int = 20, step: int = 7) -> list:
    """n pairs whose fragment of ``insert`` bases ends ``gap`` bases
    before a contig's end (n contigs long enough, evenly spaced), the
    second mate with an error every ``step`` bases: seeding misses it,
    the rescue finds it in a window that the contig's end cuts short."""
    import numpy as np
    from ..utils import dna
    rng = np.random.default_rng(seed)
    fit = [_ol(a) for a in anns if _ol(a)[1] >= insert + gap]
    pick = fit[::max(len(fit) // n, 1)][:n]
    recs = []
    for k, (off, ln) in enumerate(pick):
        e = off + ln - gap
        frag = fwd[e - insert:e]
        r2 = dna.revcomp(frag[-read_len:]).copy()
        for q in range(0, read_len, step):
            r2[q] = (r2[q] + 1 + rng.integers(0, 3)) % 4
        recs += [_rec(f"endresc_{k}", frag[:read_len]),
                 _rec(f"endresc_{k}", r2)]
    return recs


def gapped_records(fwd, lay, seed: int, lo: int = 50, hi: int = 500) -> list:
    """FASTA records [(name, sequence)] of layout ``lay`` over the
    forward text ``fwd`` (2-bit codes), with a run of N bases at the start
    of every 10th contig and at the end of every 15th, like GRCh38's
    telomere gaps: ``lo``-``hi`` bases, at most a quarter of the contig."""
    import numpy as np
    from ..utils import dna
    rng = np.random.default_rng(seed)
    recs = []
    for k, (name, off, ln) in enumerate(lay):
        s = list(dna.decode(fwd[off:off + ln]))
        for at, every in ((0, 10), (1, 15)):
            if k % every == 0:
                n = min(int(rng.integers(lo, hi + 1)), ln // 4)
                s[ln - n if at else 0:ln if at else n] = "N" * n
        recs.append((name, "".join(s)))
    return recs


def fasta_text(records, width: int = 60) -> str:
    """``records`` [(name, sequence)] as FASTA, ``width`` bases a line."""
    return "".join(
        f">{name}\n" + "".join(seq[i:i + width] + "\n"
                               for i in range(0, len(seq), width))
        for name, seq in records)
