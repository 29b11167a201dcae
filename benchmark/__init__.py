"""The benchmark of the PyTorch and CUDA aligner (``tpubwa_torch``): run a
cell with ``python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root."""
