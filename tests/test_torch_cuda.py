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

The IMU window kernel (``kernels.imu_propagate``) is held to its plain loop
(``propagator.propagate_mean_cov_ref``) on the same card inputs: B 1, 7 and
512, W 2, 17 and 64, padded tails, a window wholly outside [t0, t1], t0 and
t1 inside a sample pair, every (RK4, FEJ) pair and the discrete mean without
averaging, f32 and f64.
"""

import itertools

import numpy as np
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


IMU_NOISES = np.array([1.6968e-4, 2.0e-3, 1.9393e-5, 3.0e-3]) ** 2
IMU_GRAVITY = np.array([0.0, 0.0, 9.81])
IMU_OPTS = [(True, True, True), (True, False, True), (False, True, True), (False, False, True), (False, True, False)]


def _imu_window(B, W, seed):
    """f64 inputs of ``propagate_mean_cov`` for B streams of a W-sample window
    at 400 Hz: t0 inside the first sample pair and t1 inside the last, the
    later half of the streams padded with +inf times past two thirds of the
    window (the pair into the padding integrates to t1 on its first sample),
    the first stream's t0 before its window and, where B > 1, the last
    stream's [t0, t1] wholly before it."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    q[:, 3] = np.abs(q[:, 3]) + 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    imu = np.concatenate([q, 3 * rng.normal(size=(B, 3)), rng.normal(size=(B, 3)), 1e-2 * rng.normal(size=(B, 3)),
                          0.1 * rng.normal(size=(B, 3))], axis=1)
    fej = imu + 1e-3 * rng.normal(size=imu.shape)
    fej[:, :4] /= np.linalg.norm(fej[:, :4], axis=1, keepdims=True)
    dt = 1.0 / 400
    t = 10.0 + rng.uniform(size=(B, 1)) + dt * np.arange(W) + 1e-5 * rng.uniform(size=(B, W))
    t0, t1 = t[:, 0] + 0.3 * dt, t[:, W - 1] - 0.4 * dt
    if W > 2:
        t[B // 2:, W - W // 3:] = np.inf
    if B > 2:
        t0[0] = t[0, 0] - 1.0
    if B > 1:
        t0[-1], t1[-1] = t[-1, 0] - 6.0, t[-1, 0] - 5.0
    w = 0.3 * rng.normal(size=(B, W, 3))
    a = np.array([0.0, 0.0, 9.81]) + rng.normal(size=(B, W, 3))
    return [torch.tensor(x, device="cuda") for x in (imu, fej, t, w, a, t0, t1, IMU_NOISES, IMU_GRAVITY)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,W", list(itertools.product((1, 7, 512), (2, 17, 64))))
def test_cuda_imu_propagate_matches_plain_loop(B, W):
    """The kernel against the plain loop on the same card inputs: f64 within
    1e-12 of each output's largest value; f32 no further from the f64 loop
    than 4 times the f32 loop is (an f32 sum in another order differs by
    rounding), at least 1e-7; the window wholly outside leaves Φ = I, Qd = 0
    and the state untouched; two calls give the same bits; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc for sm_90a")
    from ov_plane_tpu_torch.state import propagator as prop

    x64 = _imu_window(B, W, seed=1000 * B + W)
    x32 = [x.float() for x in x64]
    names = ("imu", "imu_fej", "phi", "qd", "last_w")
    for rk4, fej, avg in IMU_OPTS:
        opts = prop.PropagatorOptions(use_rk4=rk4, do_fej=fej, imu_avg=avg)
        ref = prop.propagate_mean_cov_ref(*x64, opts)
        plain32 = prop.propagate_mean_cov_ref(*x32, opts)
        for x in (x64, x32):
            before = kernels.imu_propagate.launches
            got = prop.propagate_mean_cov(*x, opts)
            again = prop.propagate_mean_cov(*x, opts)
            assert kernels.imu_propagate.launches == before + 2
            torch.cuda.synchronize()
            for n, k, k2, r, p in zip(names, got, again, ref, plain32):
                case = (B, W, rk4, fej, avg, str(k.dtype), n)
                assert k.dtype == x[0].dtype and torch.equal(k, k2), case
                if k.dtype == torch.float64:
                    assert (k - r).abs().max() <= 1e-12 * r.abs().max(), case
                else:
                    err, err_plain = (k.double() - r).abs().max(), (p.double() - r).abs().max()
                    assert err <= max(4 * err_plain, 1e-7), (case, err.item(), err_plain.item())
            if B > 1:
                assert torch.equal(got[2][-1], torch.eye(15, dtype=x[0].dtype, device="cuda"))
                assert not got[3][-1].any() and not got[4][-1].any()
                assert torch.equal(got[0][-1], x[0][-1]) and torch.equal(got[1][-1], x[1][-1])


@pytest.mark.cuda
def test_cuda_propagate_and_clone_and_fast_state_propagate_reach_the_imu_kernel():
    """``propagate_and_clone`` (every filter path's propagation, here with the
    time offset calibrated) and ``fast_state_propagate`` (B·T windows) on the
    card launch the kernel once and agree with the same steps on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ov_plane_tpu_torch.state import propagator as prop
    from ov_plane_tpu_torch.state.layout import StateLayout
    from ov_plane_tpu_torch.state.vio_state import VioState

    B, W = 5, 64
    imu, fej, t, w, a, t0, _, noises, gravity = (x.cpu() for x in _imu_window(B, W, seed=3))
    lay = StateLayout(max_clones=4, max_slam=2, max_planes=1)
    st = VioState.create(lay, B, device="cpu")
    rng = np.random.default_rng(4)
    A = torch.tensor(rng.normal(size=(B, lay.dim, lay.dim)))
    full = lambda v: torch.full((B,), v, dtype=torch.float64)  # noqa: E731
    st = st.replace(t=t0 - 0.01, last_dt=full(0.01), calib_dt=full(0.002), imu=imu, imu_fej=fej,
                    cov=1e-3 * A @ A.mT + torch.eye(lay.dim, dtype=torch.float64))
    opts = prop.PropagatorOptions(do_calib_camera_timeoffset=True)
    t_new = t0 + 0.1
    card = VioState(**{k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in vars(st).items()})
    before = kernels.imu_propagate.launches
    out, slot = prop.propagate_and_clone(card, t.cuda(), w.cuda(), a.cuda(), t_new.cuda(), noises.cuda(),
                                         gravity.cuda(), opts)
    assert kernels.imu_propagate.launches == before + 1
    ref, ref_slot = prop.propagate_and_clone(st, t, w, a, t_new, noises, gravity, opts)
    assert torch.equal(slot.cpu(), ref_slot) and torch.equal(out.clones_t.cpu(), ref.clones_t)
    for name in ("imu", "imu_fej", "cov", "clones_q", "clones_p"):
        got, want = getattr(out, name).cpu(), getattr(ref, name)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max(), name
    tgt = t0[:, None] + torch.linspace(0.0, 0.12, 16, dtype=torch.float64)
    before = kernels.imu_propagate.launches
    got16, gotcov = prop.fast_state_propagate(card, t.cuda(), w.cuda(), a.cuda(), tgt.cuda(), noises.cuda(),
                                              gravity.cuda(), opts)
    assert kernels.imu_propagate.launches == before + 1
    ref16, refcov = prop.fast_state_propagate(st, t, w, a, tgt, noises, gravity, opts)
    assert (got16.cpu() - ref16).abs().max() <= 1e-12 * ref16.abs().max()
    assert (gotcov.cpu() - refcov).abs().max() <= 1e-12 * refcov.abs().max()
