"""tpubwa_torch's paired-end profiling tool (tools/profile_pe.py) on the
CPU at a tiny size: it runs to its end, prints the reference script's
step names, misses no rescue result, and its rescue task count equals
what scripts/profile_pe.py computes on the same pairs through the
reference package on the CPU. Without a card it raises unless --platform
cpu is given."""
import ctypes as C

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa.dist.mesh import pe_hist_psum as j_pe_hist_psum
from tpubwa.dist.multihost import hist_allreduce as j_hist_allreduce
from tpubwa.opts import MemOptions as JMemOptions
from tpubwa.oracle import to_copt as j_to_copt
from tpubwa_torch.tools import profile_pe
from test_torch_profile_se import world  # noqa: F401  (module fixture)

PE_PAIRS = 32


def ref_rescue_tasks(jaln, batch) -> int:
    """scripts/profile_pe.py's task count through the reference."""
    buf = np.asarray(jaln.worker1_packed(jnp.asarray(batch.seqs),
                                         jnp.asarray(batch.lens)))
    n, ovf, l_rep, flat = jaln._unpack_host(buf, batch.n)
    if ovf.any():
        n, ovf, l_rep, flat = jaln._tier2(batch, n, ovf, l_rep, flat)
    lib = jaln.oracle._lib
    copt = j_to_copt(jaln.opt.replace(flag=jaln.opt.flag | JMemOptions.F_PE))
    seqs_h = np.ascontiguousarray(batch.seqs, dtype=np.uint8)
    lens_h = np.ascontiguousarray(batch.lens, dtype=np.int32)
    flat_h = np.ascontiguousarray(flat.astype(np.int64))
    n_h = np.ascontiguousarray(n.astype(np.int32))
    lrep_h = np.ascontiguousarray(l_rep.astype(np.int32))
    n_pairs = batch.n // 2
    dirs = np.zeros(max(n_pairs, 1), np.int32)
    isz = np.zeros(max(n_pairs, 1), np.int64)
    lib.tb_pe_isize(jaln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n,
                    seqs_h.shape[1], flat_h, n_h, lrep_h, dirs, isz)
    hist = j_pe_hist_psum(jaln._pe_mesh(), dirs[:n_pairs], isz[:n_pairs],
                          jaln.opt.max_ins)
    hist_h = np.ascontiguousarray(j_hist_allreduce(hist), dtype=np.int64)
    rowsp = C.POINTER(C.c_int64)()
    return int(lib.tb_pe_rescue_tasks(
        jaln.oracle._h, C.byref(copt), seqs_h, lens_h, batch.n,
        seqs_h.shape[1], flat_h, n_h, lrep_h,
        hist_h.ctypes.data_as(C.c_void_p), jaln.opt.max_ins, 0,
        C.byref(rowsp)))


def test_profile_pe_counts_equal_reference(world, capsys):
    aln, jaln = world
    r = profile_pe.profile_pe(aln, PE_PAIRS)
    profile_pe.report(r)
    out = capsys.readouterr().out
    for name in profile_pe.STEPS[:3] + ("native_isize", "pestat_psum_device",
                                        "native_pair_sam", "n_rescue_tasks",
                                        "sum_ms", "pe_stream_reads_per_s"):
        assert f"'{name}'" in out
    want = ref_rescue_tasks(jaln, profile_pe.pairs_batch(aln, PE_PAIRS, 2))
    assert r["n_rescue_tasks"] == want > 0
    assert "rescue_kernel" in r
    assert r["rescue_results_missing"] == 0


@pytest.mark.parametrize("tool", [profile_pe])
def test_the_card_is_required_without_platform_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
