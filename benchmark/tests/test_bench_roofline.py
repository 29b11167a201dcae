"""The kernels' roofline arithmetic on known shapes, and the device idle
share on a synthetic trace."""
import numpy as np
import pytest

from benchmark import roofline, trace
from benchmark.harness import TraceData
from benchmark.metrics import (device_idle_pct, k1_roofline,
                               k2_roofline)

OPT = dict(a=1, o_del=6, e_del=1, o_ins=6, e_ins=1)


def brute_cells(q, t, w):
    return sum(max(0, min(q, i + w + 1) - max(0, i - w)) for i in range(t))


@pytest.mark.parametrize("q,t,w", [(100, 300, 100), (37, 137, 100),
                                   (150, 150, 5), (1, 1, 0), (10, 500, 3),
                                   (250, 650, 100), (0, 10, 5), (5, 0, 5),
                                   (300, 40, 20)])
def test_bench_band_cells_closed_form(q, t, w):
    assert int(roofline.band_cells(q, t, w)) == brute_cells(q, t, w)


def test_bench_k1_band_clip():
    # qlen 10, end bonus 5: max_ins = (10 + 5 - 6) / 1 + 1 = 10
    assert int(roofline.k1_band(10, 100, 5, **OPT)) == 10
    assert int(roofline.k1_band(200, 100, 5, **OPT)) == 100


def test_bench_k1_k2_launch_counts():
    q = np.array([100, 50, 80]); t = np.array([300, 150, 200])
    w = np.array([100, 100, 100]); eb = np.array([5, 5, 5])
    valid = np.array([1, 1, 0])
    cells, nbytes = roofline.k1_launch(q, t, w, eb, valid, OPT)
    assert cells == brute_cells(100, 300, 100) + brute_cells(50, 150, 50)
    assert nbytes == 4 * (150 + 450) + 2 * roofline.K1_TASK_BYTES
    cells2, nbytes2 = roofline.k2_launch(q, t, valid)
    assert cells2 == 100 * 300 + 50 * 150
    assert nbytes2 == 4 * (150 + 450) + 2 * roofline.K2_TASK_BYTES


def test_bench_int32_peak_and_bound():
    peak = roofline.int32_peak(132, 1980)      # H100 SXM: 16.7 TOP/s
    assert abs(peak - 16.727e12) < 1e9
    b = roofline.bound_s(10**9, 10, 15, peak)
    assert abs(b - 15e9 / peak) < 1e-12
    assert roofline.bound_s(1, 3.35e12, 15, peak) == pytest.approx(1.0)
    assert roofline.share_pct(0.5, 2.0) == 25.0
    assert roofline.share_pct(0.5, 0.0) is None


def _td(**kw):
    base = dict(window_s=10.0, spans={}, stats={}, paired=True, slice=None,
                k1_calls=[], k2_calls=[], opt=OPT,
                int32_peak=roofline.int32_peak(132, 1980))
    base.update(kw)
    return TraceData(**base)


def _profile(events, wall_ns):
    p = trace.Profile.__new__(trace.Profile)
    p.events = sorted(events)
    p.c0 = (0, 1_000, 2_000)
    p.c1 = (wall_ns, 1_000 + wall_ns, 2_000 + wall_ns)
    p.wall_s = wall_ns / 1e9
    return p


def test_bench_device_idle_on_synthetic_trace():
    # kernels at [100, 300) and [250, 400) overlap; a copy at [600, 700);
    # in the time.time_ns clock (offset 1000 from perf_counter)
    ev = [(1_100, 200, "ksw_extend_reg_kernel<4>"),
          (1_250, 150, "elementwise"), (1_600, 100, "Memcpy DtoH")]
    p = _profile(ev, 1_000)
    spans = trace.Spans()
    spans.intervals = [("tiers", 400, 900), ("finish", 0, 1_000)]
    s = p.summary(spans)
    assert s["busy_s"] == pytest.approx(400 / 1e9)
    s["wall_s"] = p.wall_s
    assert device_idle_pct.read(_td(slice=s)) == pytest.approx(60.0)
    gaps = {lab: round(g * 1e9) for lab, g in s["idle_gaps"]}
    assert gaps == {"host: tiers": 500, "host: finish": 100}
    assert [lab for lab, _ in s["idle_gaps"]] == ["host: tiers",
                                                  "host: finish"]
    assert s["device_ops"][0][0] == "ksw_extend_reg_kernel<4>"


def test_bench_kernel_rooflines_read_the_slice():
    peak = roofline.int32_peak(132, 1980)
    q = np.array([100]); t = np.array([300]); v = np.array([1])
    call1 = (q, t, np.array([100]), np.array([5]), v)
    cells, nb = roofline.k1_launch(*call1, OPT)
    want = roofline.bound_s(cells, nb, 15, peak)
    sl = {"kernel_s": {"ksw_extend_ring_kernel": want * 50,
                       "ksw_local_reg_kernel<5>": 1e-3}, "wall_s": 1.0,
          "busy_s": 0.1, "n_events": 2}
    td = _td(slice=sl, k1_calls=[call1], k2_calls=[(q, t, v)])
    assert k1_roofline.read(td) == pytest.approx(2.0)
    b2 = roofline.bound_s(30_000, 4 * 400 + roofline.K2_TASK_BYTES, 20, peak)
    assert k2_roofline.read(td) == pytest.approx(100 * b2 / 1e-3)
    assert k2_roofline.read(_td(slice=sl)) is None
