"""Build-and-bind helper shared by the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point; device
code the kernels share sits in headers beside them (``csrc/*.cuh``). A
source is compiled with nvcc for sm_90a into
``build/tpubwa_torch/lib<name>.so`` at first use (linked to a temporary file
and renamed into place, so a process that loads the library never sees a
half-written file), again whenever the source or a header it includes is
newer than the library, and loaded with ctypes. Nothing here runs at import
time: hosts without nvcc import every module and only fail when a kernel is
actually asked for.
"""
from __future__ import annotations

import ctypes as C
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.files import write_atomic

_REPO = Path(__file__).resolve().parents[2]
CSRC = _REPO / "tpubwa_torch" / "csrc"
BUILD = _REPO / "build" / "tpubwa_torch"
# must match csrc/ksw_common.cuh: tasks (warps) per block of both kernels;
# and the dynamic shared memory one block may ask for on sm_90
WARPS = 4
SMEM_MAX = 227 * 1024
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_files(src: Path) -> list[Path]:
    """The source and every file under csrc/ that it includes with quotes,
    directly or through another such file."""
    seen, todo = [], [Path(src)]
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.append(f)
        todo += [CSRC / name for name in _INCLUDE.findall(f.read_text())]
    return seen


class KernelLib:
    """One kernel source and its lazily built, lazily loaded library.
    ``defines`` are preprocessor macros for a variant of the source (a
    library of its own, named after them), e.g. ("KSW_NO_DPX",)."""

    def __init__(self, name: str, defines: tuple = ()):
        self.src = CSRC / f"{name}.cu"
        self.defines = tuple(defines)
        self.so = BUILD / ("_".join((f"lib{name}",) + self.defines) + ".so")
        self.ptxas_log = ""      # what -Xptxas -v said at the last build
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> Path:
        """Compile the source for sm_90a (a temporary file renamed into
        place). Returns the library path."""
        def compile_to(tmp):
            cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", str(CSRC),
                   *(f"-D{d}" for d in self.defines), "-o", tmp,
                   str(self.src)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.src.name}:\n{r.stderr}")
            self.ptxas_log = r.stderr
        return write_atomic(self.so, compile_to)

    def stale(self) -> bool:
        """True when the library is missing or older than the source or a
        header the source includes."""
        if not self.so.exists():
            return True
        built = self.so.stat().st_mtime
        return any(f.stat().st_mtime > built for f in source_files(self.src))

    def load(self, declare) -> C.CDLL:
        """The loaded library, built first when stale; ``declare(lib)`` sets
        the entry points' ctypes signatures."""
        with self._lock:
            if self._lib is None:
                if self.stale():
                    self.build()
                lib = C.CDLL(str(self.so))
                declare(lib)
                self._lib = lib
            return self._lib


def check_task_args(fn: str, names, args) -> int:
    """Argument checks shared by the kernel wrappers: the first tensor is
    the (N, Q) query on a CUDA device; every tensor must be contiguous
    int32 on that device, 2-D tensors with N rows and 1-D tensors of shape
    (N,). Returns N; raises ValueError on what the kernels do not take."""
    query = args[0]
    if query.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {query.device}")
    if query.dim() != 2:
        raise ValueError(f"{fn}: {names[0]} must be 2-D")
    N = query.shape[0]
    for name, x in zip(names, args):
        if x.device != query.device or x.dtype != torch.int32 or \
                not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous int32 "
                             f"tensor on {query.device}")
        if x.dim() not in (1, 2) or x.shape[0] != N:
            raise ValueError(f"{fn}: {name} must have {N} rows")
    return N
