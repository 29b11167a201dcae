"""One PyTorch thread in each process of the port's CPU tests.

Every tests/test_torch_*.py file imports this module. Tier 1 runs the suite
in several pytest workers on one host; with PyTorch's default of an OpenMP
thread a core in each worker, the workers' small tensor ops wait on each
other's threads: six concurrent runs of one port test on an 8-core host
took 220 s with the default and 14 s with one thread each. OMP_NUM_THREADS
reaches the processes the tests start (the command line, multihost,
run_1m) unless the caller set it.
"""
import os

import torch

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")
