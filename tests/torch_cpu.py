"""Set-up shared by every process of the port's CPU tests.

Every tests/test_torch_*.py file imports this module, and under xdist every
worker collects every file, so what runs here runs in each worker before
any test.

One PyTorch thread a process. Tier 1 runs the suite in several pytest
workers on one host; with PyTorch's default of an OpenMP thread a core in
each worker, the workers' small tensor ops wait on each other's threads:
six concurrent runs of one port test on an 8-core host took 220 s with the
default and 14 s with one thread each. OMP_NUM_THREADS reaches the
processes the tests start (the command line, multihost, run_1m) unless the
caller set it.

The reference's oracle library, built once. tpubwa.oracle.get_lib compiles
native/*.cpp straight onto build/liboracle.so whenever that file is missing
or older than the sources, with no lock: on a checkout without build/,
workers that reach the oracle at once each start a g++ onto the same path,
and one whose dlopen lands mid-write fails ("file too short"). Here
get_lib runs under an exclusive flock on build/liboracle.so.lock, so the
first worker compiles and the others wait, then find a fresh library and
only load it. The JAX package's own oracle tests in the same run load the
same library, so this covers them too. It lives here and not in
tests/conftest.py because the conftest only registers markers and forces
JAX onto the CPU.
"""
import fcntl
import os
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ORACLE_LOCK = REPO / "build" / "liboracle.so.lock"

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")


def build_once(lock_path, build):
    """Call ``build()`` while holding an exclusive flock on ``lock_path``
    (its directory made if missing) and return what it returns: processes
    that call this at once build one after another, so a build function
    that skips fresh products builds once."""
    lock_path = Path(lock_path)
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return build()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


import tpubwa.oracle  # noqa: E402  (after the thread settings above)

build_once(ORACLE_LOCK, tpubwa.oracle.get_lib)
