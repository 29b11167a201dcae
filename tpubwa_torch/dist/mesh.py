"""Reductions over the reads of a batch.

One device holds the whole batch here, so the insert-size histogram is a
plain scatter-add on it; the cross-host leg of the reduction is
``dist.multihost.hist_allreduce``.
"""
from __future__ import annotations

import numpy as np
import torch


def pe_hist_psum(dirs, inserts, max_ins: int, device) -> np.ndarray:
    """Orientation-bucketed insert-size histogram — the pestat reduction
    [bwa: mem_pestat's collect step].

    dirs: (P,) int32 in -1..3 (-1 = pair not sampled, not counted; other
    values clipped to 0..3); inserts: (P,) int, clipped to 0..max_ins.
    Host arrays of any length; the scatter-add runs on ``device``. Returns the (4, max_ins+1) int64 histogram
    ready for native mem_pestat_from_hist."""
    d = torch.as_tensor(np.asarray(dirs, np.int32)).to(device)
    ins = torch.as_tensor(np.asarray(inserts, np.int64)).to(device)
    idx = d.clamp(0, 3).to(torch.int64) * (max_ins + 1) + \
        ins.clamp(0, max_ins)
    h = torch.zeros(4 * (max_ins + 1), dtype=torch.int32, device=d.device)
    h.index_add_(0, idx, (d >= 0).to(torch.int32))
    return h.cpu().numpy().astype(np.int64).reshape(4, max_ins + 1)
