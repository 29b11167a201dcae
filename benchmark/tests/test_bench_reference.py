"""The plain reference writes the program's SAM, record for record, on a
small world (the program on the CPU: the plain versions of its kernels and
its native finish); the control, the reference with bwa's re-seeding of
long SMEMs left out put in the program's place, does not."""
import pytest

import smallworld
from benchmark import check, harness, world


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from tpubwa_torch.pipeline import Aligner
    tmp = tmp_path_factory.mktemp("small")
    bench = smallworld.make(tmp, batch_records=256)
    cells = {w: world.find_cell(bench, w, tmp, tmp / "traffic")
             for w in ("small.pe150", "small.se100")}
    cfg = cells["small.pe150"].config
    g = world.genome(cfg, tmp / "cache")
    idx, key = world.program_index(cfg, g, tmp / "cache")
    aligner = Aligner(idx, world.mem_options(cfg), device="cpu",
                      lut_cache=world.lut_path(cfg, key, tmp / "cache"))
    d = check.ensure_ref_index(cfg, g, tmp / "cache")
    batches = {}
    for w, cell in cells.items():
        trf = dict(cell.traffic)
        if trf["kind"] == "pe":
            trf["base_error_rate"] = 0.03   # mates for rescue to find
        batches[w] = world.make_batch(trf, g, 2**31 + 77, 0)
    return cfg, d, aligner, batches


@pytest.mark.parametrize("wl,id0", [("small.se100", 5), ("small.pe150", 7)])
def test_bench_reference_equals_program(small, wl, id0):
    cfg, d, aligner, batches = small
    b = batches[wl]
    paired = wl.endswith("pe150")
    pb = harness._program_batch(b)
    got = (aligner.align_pe if paired else aligner.align_se)(pb, id0=id0)
    with check.Reference(cfg, d, 2) as ref:
        want = ref.sam(b, id0, paired)
    assert want.count("\n") >= b.n
    assert check.lines_differing(got, want) == 0


@pytest.mark.parametrize("wl", ["small.se100", "small.pe150"])
def test_bench_control_fails(small, wl):
    cfg, d, aligner, batches = small
    b = batches[wl]
    paired = wl.endswith("pe150")
    with check.Reference(cfg, d, 2) as ref:
        want = ref.sam(b, 0, paired)
    with check.Reference(cfg, d, 2, **check.CONTROL) as ctl:
        got = ctl.sam(b, 0, paired)
    assert check.lines_differing(got, want) > 0
