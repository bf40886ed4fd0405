"""The yardstick's arithmetic: the kernels' bytes and operations and the
reading of a trace."""

import pytest

from devtrace import Trace
from roofline import card_peaks, downdate_work, gram_work, least_seconds, roofline_pct


@pytest.mark.parametrize("kernel,shape,size,mb,gflop,bound_ms", [
    # The port's card smoke test's figures for these shapes (PERF.md's kernel table).
    ("gram_reduce", (64, 1320, 114), 8, 84.434, 1.1268, 0.02520),
    ("gram_reduce", (64, 1320, 147), 8, 111.163, 1.8628, 0.03318),
    ("kalman_downdate", (64, 115, 114), 4, 10.069, 0.0982, 0.00301),
    ("kalman_downdate", (64, 147, 147), 4, 16.671, None, 0.00498),
])
def test_bytes_operations_and_least_time(kernel, shape, size, mb, gflop, bound_ms):
    work = gram_work if kernel == "gram_reduce" else downdate_work
    nbytes, flops = work(*shape, size)
    assert nbytes / 1e6 == pytest.approx(mb, abs=5e-4)
    if gflop is not None:
        assert flops / 1e9 == pytest.approx(gflop, abs=5e-5)
    assert least_seconds(kernel, shape, size, "NVIDIA H100 80GB HBM3") * 1e3 == pytest.approx(bound_ms, abs=5e-6)


def test_peaks_by_card():
    assert card_peaks("NVIDIA H100 80GB HBM3")[0] == 3.35e12
    assert card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    assert card_peaks("NVIDIA H100 NVL")[0] == 3.9e12


def test_roofline_share():
    calls = [((64, 1320, 114), 8)] * 2
    t = least_seconds("gram_reduce", (64, 1320, 114), 8, "H100 SXM")
    assert roofline_pct("gram_reduce", calls, 4 * t, "H100 SXM") == pytest.approx(50.0)
    assert roofline_pct("gram_reduce", [], 1.0, "H100 SXM") is None
    assert roofline_pct("gram_reduce", calls, 0.0, "H100 SXM") is None


def test_trace_reading():
    # Two frames; ranges and launches on the host, kernels on the device (ns).
    tr = Trace(frames=2, window_s=2e-6)
    tr.ranges = [("bench.frame", 0, 1000), ("bench.frame", 1000, 2000), ("frontend.klt", 100, 300),
                 ("step.propagate_and_clone", 400, 900), ("bench.gram_reduce", 500, 600),
                 ("frontend.klt", 1100, 1300), ("step.propagate_and_clone", 1400, 1900)]
    tr.launches = [(150, 1), (250, 2), (450, 3), (550, 4), (1150, 5), (1450, 6), (1950, 7)]
    tr.kernels = [("k", 200, 100, 1), ("k", 260, 100, 2), ("k", 500, 50, 3), ("gram", 600, 80, 4),
                  ("k", 1200, 100, 5), ("k", 1500, 100, 6), ("k", 1960, 20, 7)]
    assert tr.launches_in("frontend.") == 2 + 1
    assert tr.launches_in("step.") == 3
    assert tr.busy_s() == pytest.approx((160 + 50 + 80 + 100 + 100 + 20) * 1e-9)
    assert tr.device_s_of("bench.gram_reduce") == pytest.approx(80e-9)
    assert tr.top_device_ops(1) == [["k", pytest.approx(470e-9)]]
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((2000 - 510) * 1e-9)
    # Each gap goes to the innermost range open at its middle.
    assert gaps == pytest.approx({"step.propagate_and_clone": (140 + 200 + 360) * 1e-9, "(none)": (520 + 20) * 1e-9,
                                  "frontend.klt": 200e-9, "bench.gram_reduce": 50e-9}, abs=1e-15)
