"""tpubwa_torch on a 2x300 mate-pair library (MiSeq v3 reads,
unfractionated inserts over 1.5-10 kbp, FR paired-end contamination and
rescue pairs; tpubwa_torch/tools/mate_pairs.py) on
tests/test_torch_mate_pair.py's 120 kbp world, through Aligner(...,
device="cpu"): SAM byte-equal to tpubwa.pipeline.Aligner and to the oracle,
with equal stats and no rescue result missing; both K2 passes in the
generic instance at T > 13,056, past what it once held in shared memory
at Q = 300. In a file of its own so that a run with --dist loadfile
spreads it from the 2x150 cases.
"""
import torch_cpu  # noqa: F401  (one PyTorch thread a process)
from test_torch_mate_pair import (OLD_T, RESCUED, live, record,  # noqa: F401
                                  run_case, world)
from tpubwa_torch.ops import sw_local


def test_unfractionated_300(world, record):
    rows, pes, k2 = run_case(world, record, "unfractionated300")
    assert live(pes) == {"RF", "FR"}
    assert max(T for _, T, _ in k2) > OLD_T[300]
    assert {sw_local.kernel_instance(q) for q, _, _ in k2} == {0}
    assert {s for _, _, s in k2} == {True, False}
    resc = [f for f in rows if f[0].startswith("mpr_")]
    assert len(resc) == 2 * RESCUED and all(int(f[1]) & 0x2 for f in resc)
