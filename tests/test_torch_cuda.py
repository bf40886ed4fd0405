"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip. The file imports no JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit; the repository's
conftest imports JAX, so run it there without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

The sweep is chip_smoke.py's: every D of SWEEP_D with every M of SWEEP_M
(tile, chunk and split edges, empty inputs, the filters' shapes), B cycling
over 1, 5, 64; a band
of zero (masked) rows, and H at storage offset 1 (4 bytes off 16-byte
alignment in f32) in every other entry. f32 agrees to 1e-5 of the largest
value (the row sums run in another order than the plain product), f64 to
1e-12; Λ and P′ must be bitwise symmetric, and two calls bitwise equal.
"""

import pytest
import torch

from ov_plane_tpu_torch.ops import kernels

SWEEP_D = (1, 31, 32, 63, 93, 95, 96, 114, 147, 195, 300)
SWEEP_M = (0, 1, 3, 33, 93, 94, 114, 115, 147, 148, 300, 792, 1320, 4096)
SWEEP_B = (1, 5, 64)
SWEEP = [(SWEEP_B[(i + j) % 3], M, D) for i, D in enumerate(SWEEP_D) for j, M in enumerate(SWEEP_M)]
# The filters' own shapes first: the point path's (D = 93), the plane path's
# (D = 114), the vision path's merge downdates (M = 3), the MS-PL path's
# (D = 147: the SLAM update, the plane updates, the SLAM init's 33 rows), the
# anchored MS-PT run's at 4 streams, the tabletop run's at 16 and the
# dataset replay's at one stream (D = 156: the classic and SLAM updates, the
# plane updates, the SLAM init's 33 rows, the merge slots) and the ladder
# sweep's at its 20 seeds (M-PT and M-PL at D = 114, MS-PT and MS-PL at
# D = 147), and slice 8's: the calibration run's at 16 streams (D = 129 with
# the 15 calibration columns), the ZUPT's (its 6·63 = 378 rows at W = 64,
# the explicit formulation's 9), the plane-RANSAC and ground-truth runs' at
# 16 (D = 114) and the vision Monte-Carlo's at 8 seeds (D = 102, 4 plane
# slots), and slice 9's: the sharded point update's per-rank gram (each of
# two ranks takes 660 of the 1320 stacked rows, D = 93) and its f64
# downdate, the dp-sharded vision run's shapes at 2 streams per rank and 4
# in one process (the chain, the batched replay and the staged profiler
# launch the vision and point shapes above), and slice 10's: the ArUco
# replay's at one stream (D = 204 with 16 ArUco landmark slots; the bag
# replay launches the replay's), run_persistent_map's (D = 114) and
# viz_replay's (D = 141) at one stream (in f64 the rows of one stream of
# more than 64 are split over a cluster: the last, (1, 999, 141), leaves a
# short last slice). Every shape runs
# in both types: the grams in f64 (the classic update forms its Gram in f64
# whatever the filter's type), the replay's downdates in f64 and in f32.
SWEEP = [(64, 1320, 93), (64, 93, 93), (64, 1320, 114), (64, 114, 114), (64, 115, 114), (64, 3, 114),
         (64, 1320, 147), (64, 147, 147), (64, 148, 147), (64, 33, 147),
         (4, 1320, 147), (4, 147, 147), (4, 33, 147), (16, 114, 114), (16, 115, 114), (16, 3, 114),
         (1, 156, 156), (1, 157, 156), (1, 33, 156), (1, 3, 156),
         (20, 1320, 114), (20, 114, 114), (20, 115, 114), (20, 1320, 147), (20, 147, 147), (20, 148, 147),
         (20, 33, 147), (16, 1320, 129), (16, 129, 129), (16, 378, 114), (16, 9, 114), (16, 1320, 114),
         (8, 1320, 102), (8, 102, 102), (8, 103, 102), (8, 3, 102),
         (64, 660, 93), (2, 1320, 114), (2, 114, 114), (2, 115, 114), (2, 3, 114),
         (4, 1320, 114), (4, 114, 114), (4, 115, 114), (4, 3, 114),
         (1, 204, 204), (1, 205, 204), (1, 33, 204), (1, 3, 204), (1, 114, 114), (1, 115, 114),
         (1, 141, 141), (1, 142, 141), (1, 33, 141), (1, 3, 141),
         (1, 999, 141)] + SWEEP


def _inputs(B, M, D, dtype, g, offset):
    n = B * M * D
    flat = torch.randn(n + 1, generator=g, device="cuda", dtype=dtype)
    H = (flat[1:] if offset else flat[:n]).view(B, M, D)
    r = torch.randn(B, M, generator=g, device="cuda", dtype=dtype)
    if M >= 3:
        H[:, M // 3:M // 2] = 0.0
        r[:, M // 3:M // 2] = 0.0
    return H, r


def _close(a, ref, tol):
    return a.numel() == 0 or (a - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n, (B, M, D) in enumerate(SWEEP):
        H, r = _inputs(B, M, D, dtype, g, offset=n % 2 == 1)
        before = kernels.gram_reduce.launches
        lam, eta = kernels.gram_reduce(H, r)
        assert kernels.gram_reduce.launches == before + 1
        lam2, eta2 = kernels.gram_reduce(H, r)
        lam_r, eta_r = kernels.gram_reduce_ref(H, r)
        torch.cuda.synchronize()
        assert _close(lam, lam_r, tol) and _close(eta, eta_r, tol), (B, M, D)
        assert torch.equal(lam, lam.mT) and torch.equal(lam, lam2) and torch.equal(eta, eta2), (B, M, D)
        cov = lam_r / max(M, 1) + torch.eye(D, device="cuda", dtype=dtype)
        nc, dx = kernels.kalman_downdate(cov, H, r)
        nc2, dx2 = kernels.kalman_downdate(cov, H, r)
        nc_r, dx_r = kernels.kalman_downdate_ref(cov, H, r)
        torch.cuda.synchronize()
        assert _close(nc, nc_r, tol) and _close(dx, dx_r, tol), (B, M, D)
        assert torch.equal(nc, nc.mT) and torch.equal(nc, nc2) and torch.equal(dx, dx2), (B, M, D)


@pytest.mark.cuda
def test_cuda_device_prefetch_stages_on_card():
    """``parallel.ingest.device_prefetch`` on the card: the host stage's
    tensors arrive on the device, in order and equal, with the consumer's
    stream waiting on each side-stream copy (large frames, so a missing wait
    would read them half copied)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copies run on a CUDA side stream")
    from ov_plane_tpu_torch.parallel.ingest import device_prefetch

    def frame(k):
        return k, torch.full((480, 752), float(k)), {"imu": torch.arange(6.0) + k}

    got = []
    for k, img, extra in device_prefetch(range(12), device="cuda", depth=3, stage=frame):
        assert img.is_cuda and extra["imu"].is_cuda
        got.append((k, img.sum().item(), extra["imu"].tolist()))
    assert got == [(k, 480.0 * 752.0 * k, [float(j + k) for j in range(6)]) for k in range(12)]


@pytest.mark.cuda
def test_cuda_trace_spans_on_the_profilers_clock_and_device_counters():
    """``utils.trace`` on the card: spans around CUDA work hold
    torch.profiler's ranges of the same names (CPU and CUDA activity) to
    within 50 µs at either end, the median distance of the ends within
    0.1 ms, and device counters add on the card and read back once, at
    export."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from ov_plane_tpu_torch.utils import trace

    x = torch.randn(64, 256, 256, device="cuda")
    ref = torch.zeros((), dtype=torch.int64, device="cuda")
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trace.enable()
            for _ in range(4):
                with trace.span("manager.step", frame=True):
                    with trace.span("step.propagate_and_clone"):
                        for _ in range(50):
                            x = torch.tanh(x @ x * 1e-2)
                    with trace.span("step.msckf_update"):
                        trace.count("msckf.used", (x >= 0).sum(dim=(1, 2)))
                        ref += (x >= 0).sum()
            torch.cuda.synchronize()
        exp = trace.export()
    finally:
        trace.disable()
        trace.reset()
    assert exp["frames"] == 4 and len(exp["spans"]) == 12
    assert exp["counters"]["msckf.used"] == int(ref) > 0
    kineto = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA" and e.is_user_annotation():
            kineto.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    gaps = []
    for name in ("manager.step", "step.propagate_and_clone", "step.msckf_update"):
        mine = [(s["start_ns"], s["end_ns"]) for s in exp["spans"] if s["name"] == name]
        theirs = sorted(kineto[name])
        assert len(mine) == len(theirs) == 4, name
        for (a, b), (ka, kb) in zip(mine, theirs):
            assert ka - a >= -50_000 and b - kb >= -50_000, (name, ka - a, b - kb)
            gaps += [abs(a - ka), abs(b - kb)]
    assert statistics.median(gaps) <= 100_000, gaps


@pytest.mark.cuda
def test_cuda_fused_driver_device_time_is_the_cards():
    """On the card ``FusedVisionDriver.last_times["device"]`` is the device's
    elapsed time from the step's start event to its pull's copy: at least
    the device time of the work enqueued between them, at most the host's
    wall time around the whole."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.utils.config import vision_config

    cfg = vision_config()
    drv = FusedVisionDriver(cfg, VioEngine.from_config(cfg, device="cuda"), 2)
    cap = cfg.tpu.max_obs_per_frame
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = drv._start_event()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        a = torch.tanh(a @ a * 1e-3)
    e1.record()
    pull = torch.zeros(2, cap + 3, 8, device="cuda")
    pull[:, :cap, 0] = -1.0
    drv._finish(drv._record_pull(pull, drv._pull_bufs[0], start), False, dict.fromkeys(drv.TIME_KEYS, 0.0))
    wall = time.perf_counter() - t0
    work = e0.elapsed_time(e1) / 1e3
    assert set(drv.last_times) == set(drv.TIME_KEYS)
    assert 0.0 < work <= drv.last_times["device"] <= wall, (work, drv.last_times, wall)
    drv.close()
