"""K1 (``csrc/ksw_extend.cu``) against its roofline over the profiled
slice: the least time its launches' work needs (``roofline.k1_launch``,
``roofline.bound_s``) over the device time of every kernel whose name
holds ``ksw_extend``."""
from .. import roofline


def read(t):
    if t.slice is None or not t.int32_peak or not t.k1_calls:
        return None
    ks = sum(v for k, v in t.slice["kernel_s"].items() if "ksw_extend" in k)
    b = 0.0
    for qlen, tlen, w, eb, valid in t.k1_calls:
        cells, nbytes = roofline.k1_launch(qlen, tlen, w, eb, valid, t.opt)
        b += roofline.bound_s(cells, nbytes, roofline.OPS_PER_CELL["k1"],
                              t.int32_peak)
    return roofline.share_pct(b, ks)
