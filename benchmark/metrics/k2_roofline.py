"""K2 (``csrc/ksw_local.cu``) against its roofline over the profiled
slice: the least time its launches' work needs (``roofline.k2_launch``,
``roofline.bound_s``) over the device time of every kernel whose name
holds ``ksw_local``. Paired-end only (mate rescue)."""
from .. import roofline


def read(t):
    if t.slice is None or not t.int32_peak or not t.k2_calls:
        return None
    ks = sum(v for k, v in t.slice["kernel_s"].items() if "ksw_local" in k)
    b = 0.0
    for qlen, tlen, valid in t.k2_calls:
        cells, nbytes = roofline.k2_launch(qlen, tlen, valid)
        b += roofline.bound_s(cells, nbytes, roofline.OPS_PER_CELL["k2"],
                              t.int32_peak)
    return roofline.share_pct(b, ks)
