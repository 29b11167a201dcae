"""The host finish's share of the window on the host clock: the spans
around ``Aligner._finish_threaded`` (single-end: dedup, primary marking,
MAPQ, CIGAR, SAM, the oracle for reads every tier overflowed) and
``Aligner._pe_stage_b`` (paired-end: the rescue results' download, pairing
and SAM), over the window's length."""


def read(t):
    s = [t.spans[k] for k in ("finish", "pe_finish") if k in t.spans]
    return 100.0 * sum(s) / t.window_s if s else None
