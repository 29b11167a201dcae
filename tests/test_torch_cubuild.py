"""tpubwa_torch's kernel build helper: what a library is rebuilt for.

The build itself needs nvcc and a card (chip_smoke.py drives it); what it
decides from files and names is plain Python and is tested here.
"""
import os

import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from tpubwa_torch.ops import cubuild, sw, sw_local


@pytest.mark.parametrize("mod", [sw, sw_local])
def test_kernel_sources_include_the_shared_header(mod):
    files = cubuild.source_files(mod._KERNEL.src)
    assert files[0] == mod._KERNEL.src
    assert cubuild.CSRC / "ksw_common.cuh" in files
    assert all(f.exists() and f.parent == cubuild.CSRC for f in files)


def test_library_is_stale_when_a_header_is_newer(tmp_path, monkeypatch):
    monkeypatch.setattr(cubuild, "CSRC", tmp_path)
    monkeypatch.setattr(cubuild, "BUILD", tmp_path / "build")
    (tmp_path / "inner.cuh").write_text("// nothing\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '  # include "outer.cuh"\n')
    lib = cubuild.KernelLib("k")
    assert [f.name for f in cubuild.source_files(lib.src)] == \
        ["k.cu", "outer.cuh", "inner.cuh"]
    assert lib.stale()                       # no library yet
    lib.so.parent.mkdir()
    lib.so.write_bytes(b"")
    for f in tmp_path.glob("*.cu*"):
        os.utime(f, (1000, 1000))
    os.utime(lib.so, (2000, 2000))
    assert not lib.stale()
    os.utime(tmp_path / "inner.cuh", (3000, 3000))   # included indirectly
    assert lib.stale()
    os.utime(tmp_path / "inner.cuh", (1000, 1000))
    os.utime(lib.src, (3000, 3000))
    assert lib.stale()


def test_variant_builds_get_a_library_of_their_own():
    plain = cubuild.KernelLib("ksw_extend")
    variant = cubuild.KernelLib("ksw_extend", ("KSW_NO_DPX",))
    assert plain.src == variant.src and plain.so != variant.so
    assert variant.so.name == "libksw_extend_KSW_NO_DPX.so"
    assert plain.so == sw._KERNEL.so
