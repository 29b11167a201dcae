"""Named sets of alignment flags that the port is held to beyond bwa's
defaults: the same command-line letters in both packages' ``align``, used
by the options tests and ``chip_smoke.py options``.

``pacbio``, ``ont2d`` and ``intractg`` are bwa's ``mem -x`` presets (bwa.1
man page) without ``-W``, which neither command line has; ``scaled2``
doubles every score; ``knobs`` moves the band, z-drop, occurrence cap,
output threshold and unpaired penalty. No set takes ``-k`` below 12, and
the k-mer table's depth is min(12, -k, log4 of the text + 1)
(``seed.lut.default_k0``), so every set builds the default options' table
on any genome and shares its cache.
"""
from __future__ import annotations

SETS = {
    "scaled2": ("-A2", "-B8", "-O12", "-E2"),
    "pacbio": ("-k17", "-r10", "-A1", "-B1", "-O1", "-E1", "-L0"),
    "ont2d": ("-k14", "-r10", "-A1", "-B1", "-O1", "-E1", "-L0"),
    "intractg": ("-B9", "-O16", "-L5"),
    "knobs": ("-k15", "-w20", "-d30", "-c50", "-T20", "-U9"),
}
NAMES = tuple(SETS)


def options(name: str):
    """The MemOptions that ``align`` builds from set ``name``'s flags."""
    from ..cli import build_parser, opts_from_args
    return opts_from_args(build_parser().parse_args(
        ["align", "index.npz", "reads.fq", *SETS[name]]))


def scores(opt) -> dict:
    """The kernels' score keywords (ksw_extend, ksw_local) of ``opt``."""
    return dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins, a=opt.a, b=opt.b)
