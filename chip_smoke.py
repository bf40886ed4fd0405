#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ov_plane_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):

1. versions, the card's name and power limit, true-f32 matmul flags;
2. build the CUDA kernels from ``ov_plane_tpu_torch/csrc`` with nvcc;
3. check each kernel against its plain PyTorch version on the card over a
   sweep of shapes (SWEEP: tile, chunk and range edges, empty inputs, masked
   rows, a data pointer 4 bytes off 16-byte alignment), in f32 and f64, for
   tolerance, exact symmetry and bitwise-equal repeated calls; then time, at
   each path's f32 shapes (the anchored and tabletop runs' too), the kernel, the earlier simple tile kernel
   (tools/gram_simple.cu, a yardstick built here beside the package's
   kernels), the plain version and one PyTorch library call by
   device time alone (the durations of their CUDA kernels as torch.profiler
   reports them, median of 25 calls, L2 flushed before each), and the
   wrapper's host time per call;
4. drive the point path: the bench's simulator scene, 64 Monte-Carlo streams
   from a seeded generator, ``VioEngine`` + ``run_sequence`` over its first
   48 frames in f32, timed after a warm-up that also counts host
   synchronizations inside 9 steps; check the launch counts, finiteness,
   stream 0's accuracy and the agreement of two streams with an f64 CPU run
   of the port (the pose within the path's limits, and the per-frame count
   of features that passed the χ² gate equal on every stream-frame);
   profile 5 frames;
5. drive the plane path the same way (``plane_config``, the committed M-PL
   scene, its first 64 frames, 64 streams, f32): also the plane states and
   constraint updates, every final CP within 0.10 m of a true plane, and the
   per-frame plane counters against the f64 CPU run (40 frames);
5b. drive the MS-PL path the same way (``ms_pl_config``: SLAM landmarks and
   planes, D = 147, the M-PL scene, 64 frames): also SLAM inits and
   landmarks on every stream, landmark updates, and the per-frame SLAM and
   plane counters against the f64 CPU run (30 frames, the first SLAM inits
   at frame 20); then 4 streams of MS-PT with anchored landmarks
   (``ANCHORED_MSCKF_INVERSE_DEPTH``, planes off) step by step until
   landmarks have moved to a new anchor clone, its launch counts checked;
6. drive the vision path, the system's main path (``vision_config``, the
   bench's vision mode): render the first 64 frames of the committed vision scene
   on the card, add each stream's fixed pixel noise, quantize to the 8-bit
   lattice and stage the ring on the card; ``VioEngine.from_config`` →
   ``FusedVisionDriver(cfg, eng, 64)`` → ``init_frontend`` → ``stage_image``
   → ``step_batch`` per frame → ``flush_stream``. A 12-frame warm-up counts
   the host synchronizations per step (only the one packed pull), then 80
   frames from a fresh state are timed: launch counts, stream 0's accuracy,
   the host detector's plane labels reaching the step and delayed-init
   candidates over the 64 streams, and streams 0–1 against the port's CPU
   run (frontend f32, filter f64) over 20 frames; a 5-frame profile by range;
6b. the fused path's plane update on the tabletop scene (``tabletop_config``,
   the JAX package's plane-firing scene): its 46 frames rendered on the card,
   16 streams through ``step_batch`` in f32: the launch counts, CP plane
   inits, planes in the state and constraint updates must appear, and the
   plane counters of stream 0 and of the first other stream with a plane in
   the state are held against the port's CPU run (filter f64) of the same
   inputs: stream 0's first plane at the same frame and its counters equal
   on at least 44 of 46 frames (the other stream printed);
7. print the ``{"kernels": [...]}`` line, then the device line last.

Needs a CUDA card: without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import bisect
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import torch

BATCH = 64
SEED = 7
ANCHOR_BATCH = 4        # streams of the anchored-landmark run
TABLETOP_BATCH = 16     # streams of the tabletop phase
# Each path's kernel shapes (B, M, D): the gram stacks 40 features × (3·12 − 3)
# rows over the D state columns (93 on the point path, 114 with 8 plane
# slots); the downdate closes the classic update with M = D rows, and on the
# plane path the grouped plane update and both delayed-init candidates with
# M = D + 1.
GRAM_M = 40 * (3 * 12 - 3)
# The vision path stacks max(max_msckf_update, max_msckf_in_update) = 40
# features too, and adds the eight merge slots' 3-row downdates per frame.
# The MS-PL path (D = 147 with 12 landmark slots) adds the SLAM update (its
# QR-compressed rows, M = D) and the eight delayed-init candidates' leftover
# rows (M = 3K − 3 = 33) to the plane path's downdates; the anchored run
# (MS-PT, the same layout) has the classic update, the SLAM update and the
# eight candidates at its own B. The tabletop phase (16 streams through the
# fused driver) compresses its classic update by QR, so it launches no gram:
# the vision path's downdates at its B.
PATH_SHAPES = {
    "point": {"gram_reduce": [(BATCH, GRAM_M, 93)], "kalman_downdate": [(BATCH, 93, 93)]},
    "plane": {"gram_reduce": [(BATCH, GRAM_M, 114)], "kalman_downdate": [(BATCH, 114, 114), (BATCH, 115, 114)]},
    "ms-pl": {"gram_reduce": [(BATCH, GRAM_M, 147)],
              "kalman_downdate": [(BATCH, 147, 147), (BATCH, 148, 147), (BATCH, 33, 147)]},
    "vision": {"gram_reduce": [(BATCH, GRAM_M, 114)],
               "kalman_downdate": [(BATCH, 114, 114), (BATCH, 115, 114), (BATCH, 3, 114)]},
    "anchored": {"gram_reduce": [(ANCHOR_BATCH, GRAM_M, 147)],
                 "kalman_downdate": [(ANCHOR_BATCH, 147, 147), (ANCHOR_BATCH, 33, 147)]},
    "tabletop": {"gram_reduce": [],
                 "kalman_downdate": [(TABLETOP_BATCH, 114, 114), (TABLETOP_BATCH, 115, 114),
                                     (TABLETOP_BATCH, 3, 114)]},
}
# The shape whose numbers lead each kernel's entry of the {"kernels": ...}
# line: the gram's, and the downdate's largest (M = D + 1, three of the
# vision path's twelve launches per frame and most of their time).
LEAD = {"gram_reduce": (BATCH, GRAM_M, 114), "kalman_downdate": (BATCH, 115, 114)}
# f32 kernel vs plain: max|kernel − plain| ≤ TOL·max|plain| (the row sums run
# in another order); f64 the same at 1e-12.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# Published dense peaks outside the tensor cores (NVIDIA data sheets):
# (memory bytes/s, f32 FLOP/s).
PEAKS = {"SXM": (3.35e12, 67e12), "PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12)}


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


EARLIER_SRC = Path(__file__).resolve().parent / "tools" / "gram_simple.cu"
FLUSH_BYTES = 256 << 20  # written before each timed call: five times the 50 MB L2
# The correctness sweep: every D (tile edges 31/32/63/95/96, the filters' 93,
# 114 and 147, the calibrated 195, the largest 300) with every M (empty, one
# chunk or less, chunk and row-range edges, the filters' 33, 93, 114, 115,
# 147, 148 and 1320, a long 4096), B cycling over 1, 5, 64. Even entries take
# H at storage offset 1 (4 bytes off 16-byte alignment in f32), and every
# entry has a band of zero (masked) rows.
SWEEP_D = (1, 31, 32, 63, 93, 95, 96, 114, 147, 195, 300)
SWEEP_M = (0, 1, 3, 33, 93, 94, 114, 115, 147, 148, 300, 792, 1320, 4096)
SWEEP_B = (1, 5, 64)
SWEEP = [(SWEEP_B[(i + j) % 3], M, D) for i, D in enumerate(SWEEP_D) for j, M in enumerate(SWEEP_M)]


def _is_flush(name: str) -> bool:
    """The flush's own kernels: the uint8 rewrite and read (and a memset the read may launch)."""
    return "bitwise_not" in name or "unsigned char" in name or name.startswith("Memset")


def device_ms(fn, n: int = 25, warmup: int = 3, attempts: int = 3, parts: dict | None = None) -> float:
    """Median device time of one call of ``fn``: the summed durations of the
    CUDA kernels it launches, as torch.profiler reports them. Before each call
    two kernels rewrite and then read FLUSH_BYTES of uint8, so every call finds
    the L2 cold and clean (no write-back of the flush's own lines is left to
    it); they are left out of the sum, and so is the host's time between
    launches. A profile that lost a kernel (the count is checked) is taken
    again. ``parts``, if given, receives each kernel's median ms by name."""
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flush():
        buf.bitwise_not_()
        buf.amax()

    for _ in range(warmup):
        flush()
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(n):
                flush()
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"), key=lambda e: e.time_range.start)
        calls, in_flush, by_name = [], True, {}
        for e in events:
            if _is_flush(e.name):
                in_flush = True
                continue
            if in_flush:
                calls.append(0.0)
                in_flush = False
            calls[-1] += e.time_range.end - e.time_range.start
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        if len(calls) == n and all(c > 0 for c in calls):
            if parts is not None:
                parts.update({k: statistics.median(v) / 1e3 for k, v in by_name.items()})
            return statistics.median(calls) / 1e3
        print(f"[time] the profile holds {len(calls)} of {n} timed calls; profiling again")
    raise RuntimeError(f"the profiler did not record the {n} timed calls in {attempts} attempts")


def host_us(fn, n: int = 200) -> float:
    """Median host time of one call of ``fn`` (its launch, not its device work)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def start_earlier_build(kernels):
    """Start nvcc on the earlier simple tile kernel (EARLIER_SRC), the timing
    yardstick, with the package's flags; returns a function that waits for
    it and returns its launcher ``earlier(X, x, base=None)`` for f32 CUDA
    tensors: (Gram, vec) without a base, (base − Gram, vec) with one."""
    src = EARLIER_SRC.read_bytes()
    out = kernels.BUILD_DIR / f"libovp_gram_simple_{hashlib.sha256(src).hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    proc = None if out.exists() else subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(EARLIER_SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        if proc is not None:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {EARLIER_SRC.name}:\n{report}")
            tmp.replace(out)
        fn = ctypes.CDLL(str(out)).ovp_gram_simple_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def earlier(X, x, base=None):
            B, M, D = X.shape
            res = torch.empty(B, D, D, device=X.device)
            vec = torch.empty(B, D, device=X.device)
            err = fn(X.data_ptr(), x.data_ptr(), None if base is None else base.data_ptr(), res.data_ptr(),
                     vec.data_ptr(), B, M, D, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"gram_simple kernel launch failed with cudaError_t {err}")
            return res, vec
        return earlier
    return wait


def _inputs(kname, B, M, D, dtype, g, offset=False, zero_rows=True):
    dev = "cuda"
    n = B * M * D
    X = torch.randn(n + 1, generator=g, device=dev, dtype=dtype)[1:] if offset else \
        torch.randn(n, generator=g, device=dev, dtype=dtype)
    X = X.view(B, M, D)
    x = torch.randn(B, M, generator=g, device=dev, dtype=dtype)
    if zero_rows and M >= 3:
        X[:, M // 3:M // 2] = 0.0
        x[:, M // 3:M // 2] = 0.0
    if kname == "gram_reduce":
        return (X, x)
    A = torch.randn(B, D, D, generator=g, device=dev, dtype=dtype)
    P = A @ A.transpose(-1, -2) / D + torch.eye(D, device=dev, dtype=dtype)
    return (P, X, x)


def check_kernels(kernels):
    """Phase 3a: each kernel against its plain version over the sweep, f32 and
    f64: tolerance, bitwise symmetry, two calls bitwise equal. Returns the
    max |kernel − plain| at each path's f32 shapes, by (kernel, shape)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs, failures = {}, []
    for kname in ("gram_reduce", "kalman_downdate"):
        kern, ref_fn = getattr(kernels, kname), getattr(kernels, kname + "_ref")
        for dtype in (torch.float32, torch.float64):
            worst = 0.0
            path_shapes = sorted({sh for p in PATH_SHAPES.values() for sh in p[kname]})
            shapes = [(sh, False) for sh in path_shapes] + [(s, i % 2 == 0) for i, s in enumerate(SWEEP)]
            for (B, M, D), offset in shapes:
                args = _inputs(kname, B, M, D, dtype, g, offset=offset)
                try:
                    out, vec = kern(*args)
                    out2, vec2 = kern(*args)
                    ref, ref_vec = ref_fn(*args)
                    torch.cuda.synchronize()
                except Exception:
                    print(f"[check] {kname} {str(dtype)[6:]} B={B} M={M} D={D} offset={offset} raised")
                    raise
                err = max((out - ref).abs().max().item(), (vec - ref_vec).abs().max().item() if vec.numel() else 0.0)
                scale = max(ref.abs().max().item(), ref_vec.abs().max().item() if vec.numel() else 0.0)
                ok = (err <= TOL[dtype] * scale and torch.equal(out, out.transpose(-1, -2))
                      and torch.equal(out, out2) and torch.equal(vec, vec2) and bool(torch.isfinite(out).all()))
                worst = max(worst, err / scale if scale > 0 else err)
                if (B, M, D) in path_shapes and not offset and dtype == torch.float32:
                    errs.setdefault((kname, (B, M, D)), err)
                if not ok:
                    failures.append(f"{kname} {str(dtype)[6:]} B={B} M={M} D={D} offset={offset}: err {err:.3e} "
                                    f"limit {TOL[dtype] * scale:.3e} symmetric {torch.equal(out, out.mT)} "
                                    f"repeatable {torch.equal(out, out2) and torch.equal(vec, vec2)}")
                    print(f"[check] FAIL {failures[-1]}")
            print(f"[check] {kname} {str(dtype)[6:]}: {len(shapes)} shapes, worst max_abs_err/max|plain| "
                  f"{worst:.3e} (limit {TOL[dtype]:.0e}); bitwise symmetric and repeatable")
    if failures:
        raise RuntimeError(f"{len(failures)} kernel checks failed: {failures[:5]}")
    return errs


def time_kernels(kernels, errs, earlier_kernel):
    """Phase 3b: device time (torch.profiler, cold L2) of each kernel, of the
    earlier simple tile kernel (checked against the plain version first), of
    the plain version and of one library call at each path's f32 shapes; the
    wrapper's host time; the bound. Returns the rows by (kernel, shape)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    mem_bps, f32_flops = card_peaks(torch.cuda.get_device_name(0))
    rows = {}
    todo = sorted({(k, sh) for p in PATH_SHAPES.values() for k, shs in p.items() for sh in shs})
    for kname, (B, M, D) in todo:
        kern, ref_fn = getattr(kernels, kname), getattr(kernels, kname + "_ref")
        args = _inputs(kname, B, M, D, torch.float32, g, zero_rows=False)
        if kname == "gram_reduce":
            X, x = args
            Xa = torch.cat([X, x[..., None]], dim=-1)
            lib = lambda: torch.bmm(X.transpose(-1, -2), Xa)  # [HᵀH | Hᵀr]  # noqa: E731
            earlier = lambda: earlier_kernel(X, x)  # noqa: E731
            bytes_ = 4 * (B * M * D + B * M + B * D * D + B * D)
        else:
            P, X, x = args
            Xa = torch.cat([X, -x[..., None]], dim=-1)
            Pa = torch.cat([P, torch.zeros(B, D, 1, device="cuda")], dim=-1)
            lib = lambda: torch.baddbmm(Pa, X.transpose(-1, -2), Xa, alpha=-1.0)  # [P−WᵀW | −Wᵀu]  # noqa: E731
            earlier = lambda: earlier_kernel(X, x, P)  # noqa: E731
            bytes_ = 4 * (2 * B * D * D + B * M * D + B * M + B * D)
        flops = 2 * B * M * (D * (D + 1) // 2 + D)  # upper triangle + the folded column
        t_bytes, t_ops = bytes_ / mem_bps * 1e3, flops / f32_flops * 1e3
        bound = max(t_bytes, t_ops)
        e_out, ref_out = earlier(), ref_fn(*args)
        e_err = max((a - b).abs().max().item() for a, b in zip(e_out, ref_out))
        if not e_err <= TOL[torch.float32] * max(b.abs().max().item() for b in ref_out):
            raise RuntimeError(f"the earlier {kname} kernel disagrees with the plain version: {e_err:.3e}")
        calls_before = kern.launches
        k_parts = {}
        k_ms = device_ms(lambda: kern(*args), parts=k_parts)
        k_host = host_us(lambda: kern(*args))
        kern.launches = calls_before
        e_ms, p_ms, l_ms = device_ms(earlier), device_ms(lambda: ref_fn(*args)), device_ms(lib)
        rows[(kname, (B, M, D))] = dict(max_abs_err=errs[(kname, (B, M, D))], ms=k_ms, device_ms=k_ms, earlier_device_ms=e_ms,
                           plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                           bound_by="bytes" if t_bytes >= t_ops else "operations",
                           pct_of_bound=100.0 * bound / k_ms, host_us_per_call=k_host,
                           bytes=bytes_, flops=flops)
        print(f"[time] {kname} f32 B={B} M={M} D={D}, device time, cold L2: kernel {k_ms:.5f} ms "
              f"({100 * bound / k_ms:.1f}% of bound), earlier kernel {e_ms:.5f} ms, plain {p_ms:.5f} ms, "
              f"library {l_ms:.5f} ms, bound {bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{bytes_ / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP)")
        print(f"[time] {kname} its kernels: " + ", ".join(f"{k.split('<')[0].split()[-1]} {v:.5f} ms"
                                                        for k, v in k_parts.items()))
        print(f"[time] {kname} wrapper host time {k_host:.2f} us per call")
    return rows


class PathSpec(NamedTuple):
    """One path of the filter that the script drives at full width."""
    name: str
    config: str             # function of ov_plane_tpu_torch.utils.config
    scene: str              # attribute of ov_plane_tpu_torch.sim.simulator holding the scene's path
    per_frame: dict         # kernel launches per stepped frame
    sync_start: int         # first of the 9 steps checked for host synchronizations (then profiled from)
    ref_frames: int         # frames of the f64 CPU reference
    n_frames: int | None = None  # stepped frames (None: the whole scene)
    pose_limits: tuple = (1e-2, 1e-3)   # card f32 vs CPU f64: max |Δp| in m, max |Δq|


PATHS = (
    # Phase 4: the point path on the bench scene (slice 1), cut to its first
    # 48 frames (its CPU check to 20) to pay for the SLAM and tabletop phases
    # within the time limit.
    PathSpec("point", "slice_config", "SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 1}, 4, 20, 48),
    # Phase 5: the plane path on the M-PL scene (slice 3), cut to its first
    # 64 frames (CPU check 40): the downdate closes the classic update, the
    # grouped plane update and both delayed-init candidates; the first plane
    # state appears at frame 20.
    PathSpec("plane", "plane_config", "PLANE_SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 4}, 18, 40, 64),
    # Phase 5b: MS-PL on the same scene (slice 5): the plane path's downdates,
    # the SLAM update and the eight delayed-init candidates; the first SLAM
    # inits come at frame 20, so 64 frames hold 44 frames of landmarks, the
    # sync check covers steps 21-29 and the CPU check frames 1-30. Its f32
    # pose limits are twice the largest card f32 reading over the noise draws
    # of seeds 7-12 (|Δp| 1.417e-2 m, |Δq| 8.178e-3, before any landmark;
    # tools/plane_precision.py --path ms-pl --seeds ...): the classic update's
    # f32 information form at D = 147 carries the error, with the kernels or
    # with their plain versions alike (PERF.md §6).
    PathSpec("ms-pl", "ms_pl_config", "PLANE_SCENE_PATH", {"gram_reduce": 1, "kalman_downdate": 13}, 21, 30, 64,
             (3e-2, 1.7e-2)),
)
PLANE_COUNTERS = ("n_planes", "n_plane_init", "n_plane_constraints", "n_plane_merges", "n_plane_dropped")
SLAM_COUNTERS = ("n_slam", "n_slam_init", "n_slam_update")


def _setup(spec: PathSpec, device, dtype, seed: int = SEED):
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils import config

    cfg = getattr(config, spec.config)()
    truth = simulator.load_scene(getattr(simulator, spec.scene), dtype=dtype, device=device)
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), BATCH,
                                torch.Generator(device=device).manual_seed(seed))
    return cfg, truth, sim, VioEngine.from_config(cfg, device=device)


def _fresh(eng, cfg, s, b, device, dt):
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import init_state_with_gt

    st = init_state_with_gt(eng, cfg, t0=s.cam_t_imu[0].expand(b), q0=s.gt_q[0].expand(b, 4),
                            p0=s.gt_p[0].expand(b, 3), v0=s.gt_v[0].expand(b, 3),
                            bg0=s.gt_bg_cam[:b, 0], ba0=s.gt_ba_cam[:b, 0], dtype=dt, device=device)
    return st, FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, b, dt, device)


def cpu_run(cfg, sim, n_frames: int, dtype=torch.float64):
    """The first two streams of the card's noisy scene ``sim`` through the
    port on the CPU (plain kernel versions) in ``dtype``; returns the outputs."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence

    noisy = ("imu_w", "imu_a", "obs_uv", "gt_bg", "gt_ba", "gt_bg_cam", "gt_ba_cam")
    sim_cpu = sim._replace(**{k: v[:2].to(dtype).cpu() for k, v in sim._asdict().items() if k in noisy},
                           **{k: v.to(dtype).cpu() if v.is_floating_point() else v.cpu()
                              for k, v in sim._asdict().items()
                              if isinstance(v, torch.Tensor) and k not in noisy})
    eng = VioEngine.from_config(cfg, device="cpu")
    st, bk = _fresh(eng, cfg, sim_cpu, 2, "cpu", dtype)
    return run_sequence(eng, st, bk, sim_cpu, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)[2]


def drive_path(spec: PathSpec):
    """Phases 4 and 5: one path of the port at full width, B streams in f32
    over the scene; returns (n_frames, launches, info)."""
    from ov_plane_tpu_torch import convert  # noqa: F401  (package import check)
    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.manager import run_sequence
    from ov_plane_tpu_torch.ops import kernels

    tag = f"[{spec.name}]"
    dev, dtype = "cuda", torch.float32
    t = time.time()
    cfg, truth, sim, eng = _setup(spec, dev, dtype)
    total = sim.cam_t.shape[0] - 1
    n_frames = total if spec.n_frames is None else min(spec.n_frames, total)
    window = cfg.tpu.max_imu_per_frame
    print(f"{tag} scene {total + 1} frames, {sim.imu_t.shape[0]} IMU samples, {truth.obs_id.shape[1]} observation "
          f"slots; D={eng.layout.dim}; B={BATCH}; {n_frames} frames stepped; set-up {time.time() - t:.2f} s")

    # Warm-up (library handles, allocator) up to the checked window, then 9
    # steps with host synchronizations counted (warnings from
    # torch.cuda.set_sync_debug_mode); the state after them is kept for the
    # profile. Then the timed run from a fresh state.
    state, bank = _fresh(eng, cfg, sim, BATCH, dev, dtype)
    s0, s1 = spec.sync_start, spec.sync_start + 9
    t = time.time()
    state, bank, _ = run_sequence(eng, state, bank, sim, imu_window=window, n_frames=s0 - 1)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            snapshot = run_sequence(eng, state, bank, sim, imu_window=window, n_frames=9, start=s0)[:2]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    print(f"{tag} host synchronizations inside steps {s0}-{s1 - 1}: {len(syncs)} {syncs[:5]} "
          f"(warm-up and check {time.time() - t:.1f} s)")
    if syncs:
        raise RuntimeError("the step synchronizes with the host")

    state, bank = _fresh(eng, cfg, sim, BATCH, dev, dtype)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=window, n_frames=n_frames)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} {BATCH}x{n_frames} stream-frames in {wall:.3f} s: "
          f"{BATCH * n_frames / wall:.1f} stream-frames/s ({n_frames / wall:.2f} frames/s per stream)")
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != spec.per_frame[k] * n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames, not {spec.per_frame[k]} per frame")

    for name, v in outs._asdict().items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"non-finite output {name}")
    if not (torch.isfinite(state.cov).all() and torch.isfinite(state.imu).all()):
        raise RuntimeError("non-finite final state")
    m = rmse_nees(outs.q.double(), outs.p.double(), outs.cov_diag_imu[..., 0:3].double(),
                  outs.cov_diag_imu[..., 3:6].double(), sim.gt_q[1:n_frames + 1].double(),
                  sim.gt_p[1:n_frames + 1].double())
    rmse0 = m["rmse_pos"][0].item()
    print(f"{tag} stream 0: rmse_pos={rmse0:.4f} m rmse_ori={m['rmse_ori_deg'][0].item():.4f} deg; "
          f"mean over {BATCH} streams: rmse_pos={m['rmse_pos'].mean().item():.4f} m "
          f"rmse_ori={m['rmse_ori_deg'].mean().item():.4f} deg "
          f"nees_ori={m['nees_ori'].mean().item():.3f} nees_pos={m['nees_pos'].mean().item():.3f}; "
          f"msckf features used per frame (mean) {outs.n_msckf_used.float().mean().item():.2f}")
    if not rmse0 < 0.5:
        raise RuntimeError(f"stream 0 position RMSE {rmse0:.3f} m is not below 0.5 m")
    info = dict(stream_frames_per_s=BATCH * n_frames / wall, wall_s=wall, n_frames=n_frames,
                eng=eng, cfg=cfg, sim=sim, snapshot=snapshot)
    if eng.use_planes:
        info.update(check_planes(tag, state, outs, truth))
    if eng.use_slam:
        check_slam(tag, state, outs)

    # Reference on a small input: two of the streams through the port on the
    # CPU in f64 (plain kernel versions), against the card's f32 run.
    n_ref = min(spec.ref_frames, n_frames)
    t = time.time()
    ref = cpu_run(cfg, sim, n_ref)
    dp = (outs.p[:2, :n_ref].double().cpu() - ref.p).abs().max().item()
    dq = (outs.q[:2, :n_ref].double().cpu() - ref.q).abs().max().item()
    print(f"{tag} card f32 vs CPU f64 ({time.time() - t:.1f} s on the CPU), 2 streams x {n_ref} frames: "
          f"max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    agree = compare_counters(tag, outs, ref, n_ref, ("n_msckf_used",) + (PLANE_COUNTERS if eng.use_planes else ())
                             + (SLAM_COUNTERS if eng.use_slam else ()))
    if min(agree.values()) < 1.0:
        raise RuntimeError(f"per-frame counters differ from the CPU f64 run's: share of stream-frames equal {agree}")
    if not (dp < spec.pose_limits[0] and dq < spec.pose_limits[1]):
        raise RuntimeError(f"the card's run disagrees with the CPU f64 reference (limits {spec.pose_limits})")
    return n_frames, launches, info


def check_planes(tag, state, outs, truth):
    """The plane path's own checks: plane states were made and used, and every
    active CP lies within 0.10 m of a true plane CP (tests/test_e2e_planes.py)."""
    n_planes = outs.n_planes.max().item()
    n_constraints = outs.n_plane_constraints.sum().item()
    dropped = outs.n_plane_dropped.sum().item()
    print(f"{tag} in-state planes at most {n_planes} per stream; plane constraint updates {n_constraints} "
          f"({n_constraints / outs.n_planes.shape[0]:.1f} per stream); delayed inits "
          f"{outs.n_plane_init.sum().item()} (counted before the 2 s delay gate, as in JAX); "
          f"n_plane_dropped summed {dropped}")
    if n_planes == 0 or n_constraints == 0:
        raise RuntimeError("no plane state or no plane constraint update on any stream")
    cp_est = state.plane_cp[state.plane_active].double()
    if cp_est.shape[0]:
        dist = torch.cdist(cp_est, truth.plane_cp.double()).min(dim=1).values
        print(f"{tag} {cp_est.shape[0]} active CPs at the end; distance to the nearest true CP: "
              f"max {dist.max().item():.4f} m, mean {dist.mean().item():.4f} m")
        if not dist.max().item() < 0.10:
            raise RuntimeError("an active plane CP lies farther than 0.10 m from every true plane CP")
    else:
        print(f"{tag} no active CP at the end")
    return dict(n_plane_dropped=dropped, n_plane_constraints=n_constraints)


def check_slam(tag, state, outs):
    """The SLAM path's own checks: every stream initialized landmarks and
    held some in the state at some frame, and landmark updates were applied."""
    inits = outs.n_slam_init.sum(dim=1)
    held = outs.n_slam.max(dim=1).values
    first = (outs.n_slam_init.sum(dim=0) > 0).nonzero()
    print(f"{tag} SLAM: first init at frame {int(first[0]) + 1 if first.numel() else None}; inits per stream "
          f"min {inits.min().item()} mean {inits.float().mean().item():.1f}; landmarks held at most "
          f"{held.max().item()} (min over streams {held.min().item()}); landmark updates "
          f"{outs.n_slam_update.sum().item()} ({outs.n_slam_update.float().mean().item():.2f} per stream-frame); "
          f"{state.slam_active.sum().item()} landmarks active at the end")
    if not (inits.min().item() > 0 and held.min().item() > 0 and outs.n_slam_update.sum().item() > 0):
        raise RuntimeError("a stream initialized no SLAM landmark, or no landmark update was applied")
    if not torch.isfinite(state.slam_p[state.slam_active]).all():
        raise RuntimeError("non-finite SLAM landmark")


def compare_counters(tag, outs, ref, n_ref, names):
    """Per-frame counters (features that passed the χ² gate, the plane
    counters) of the card's f32 run against the CPU f64 run; where f32 takes
    a gate that f64 does not (or the reverse), the frame and the counter are
    printed. Returns each counter's share of agreeing stream-frames."""
    agree = {}
    for name in names:
        card = getattr(outs, name)[:2, :n_ref].cpu()
        cpu = getattr(ref, name)
        diff = (card != cpu).nonzero().tolist()
        agree[name] = 1.0 - len(diff) / card.numel()
        print(f"{tag} {name} per frame: card == CPU f64 on {card.numel() - len(diff)} of {card.numel()} "
              f"stream-frames; totals card {card.sum().item()} CPU {cpu.sum().item()}")
        for b, f in diff[:10]:
            print(f"{tag}   gate flipped: stream {b} frame {f + 1} {name} card {card[b, f].item()} "
                  f"CPU f64 {cpu[b, f].item()}")
    return agree


def _raw_events(prof):
    """(name, on the device, start ns, duration ns) of every event of a
    profile, read from the profiler's raw results: building ``prof.events()``
    takes minutes for a few frames of ~60k kernels each."""
    return [(e.name(), e.device_type().name == "CUDA", e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def profile_frames(spec: PathSpec, info: dict, n: int = 5):
    """Where a frame's time goes (torch.profiler over the n frames after the
    checked window, from the state the path's run kept): device kernel time
    and kernel count per frame, the device's idle share of an unprofiled
    frame (from the path's run), and each stage's host time (inflated by the
    profiler's own overhead) and kernel launches."""
    from ov_plane_tpu_torch.models.manager import STAGES, run_sequence
    from torch.profiler import ProfilerActivity, profile

    tag = f"[profile {spec.name}]"
    eng, cfg, sim = info["eng"], info["cfg"], info["sim"]
    st, bk = info["snapshot"]
    first = spec.sync_start + 9
    frame_wall_ms = 1e3 * info["wall_s"] / info["n_frames"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run_sequence(eng, st, bk, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n, start=first)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    report_profile(tag, prof, STAGES, first, n, frame_wall_ms, wall_ms)


def report_profile(tag, prof, ranges, first, n, frame_wall_ms, wall_ms):
    """Print a profile of n frames: kernels and device busy time per frame,
    the device's idle share of an unprofiled frame, each range's host ms
    (inflated by the profiler) and kernel launches, the largest kernels."""
    t = time.time()
    events = _raw_events(prof)
    # A range's host span and its device annotation share one name: the
    # kernels are the device events with other names.
    kern = [(name, dur) for name, dev, _, dur in events if dev and name not in ranges]
    busy_ms = sum(dur for _, dur in kern) / 1e6 / n
    if busy_ms <= 0:
        print(f"{tag} the profiler recorded no device time: device idle share not measured")
        return
    print(f"{tag} frames {first}-{first + n - 1}: {len(kern) / n:.0f} kernels per frame, device busy {busy_ms:.2f} ms; "
          f"unprofiled frame {frame_wall_ms:.2f} ms -> device idle {100 * (1 - busy_ms / frame_wall_ms):.1f}%; "
          f"profiled frame {wall_ms / n:.2f} ms")
    spans = sorted((t0, t0 + dur, name) for name, dev, t0, dur in events if name in ranges and not dev)
    host = dict.fromkeys(ranges, 0.0)
    for s0, s1, name in spans:
        host[name] += (s1 - s0) / 1e6 / n
    launches = dict.fromkeys(ranges, 0)
    starts = [s0 for s0, _, _ in spans]
    for name, dev, t0, _ in events:
        if not dev and name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t0 <= spans[i][1]:
                launches[spans[i][2]] += 1
    print(f"{tag} host ms per frame by range (profiled): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    print(f"{tag} kernel launches per frame by range: " + ", ".join(f"{k} {v / n:.0f}" for k, v in launches.items()))
    by_name = {}
    for name, dur in kern:
        tot, c = by_name.get(name, (0, 0))
        by_name[name] = (tot + dur, c + 1)
    for name, (tot, c) in sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]:
        print(f"{tag}   {tot / 1e6 / n:8.3f} ms/frame  x{c // n:5d}  {name[:80]}")
    print(f"{tag} events read in {time.time() - t:.1f} s")


VISION_FRAMES = 64      # the first 64 of the bench's 80 vision frames (bench.py:116)
VISION_WARM = 12        # warm-up frames, the host synchronizations counted from the third
VISION_REF = 20         # frames of streams 0-1 against the port's CPU run
ANCHOR_FRAMES = 44      # its frames: the first inits at frame 20 move anchor some 11 frames later
TABLETOP_LAYERS = dict(texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))   # tests/test_fused_planes.py
VISION_PER_FRAME = {"gram_reduce": 1, "kalman_downdate": 12}   # classic 1, plane 1, init 2, merge slots 8
ANCHOR_PER_FRAME = {"gram_reduce": 1, "kalman_downdate": 10}   # classic 1, SLAM update 1, init candidates 8
TABLETOP_PER_FRAME = {"gram_reduce": 0, "kalman_downdate": 12}  # the vision path's, the classic update by QR
TABLETOP_MIN_EQUAL = 44  # of stream 0's 46 frames, plane counters equal to the CPU f64 run's (46 seen)
VISION_RANGES = ("frontend.preprocess", "frontend.klt", "frontend.ransac", "frontend.fast", "frontend.triangulate",
                 "step.propagate_and_clone", "step.ingest", "step.triage", "step.plane_init", "step.plane_msckf",
                 "step.msckf_update", "step.marginalize", "host.plane_detect", "pull")


class VisionRun(NamedTuple):
    cfg: object
    truth: object
    imu: tuple              # host (imu_t [Ti], imu_w [B, Ti, 3], imu_a [B, Ti, 3], cam_t_imu [Tc])
    gt_bg0: torch.Tensor    # [B, 3] the noisy draws' bias truth at frame 0
    gt_ba0: torch.Tensor
    ring: list              # staged frames, [B, h, w] on the card
    sampler: str
    wire: str


def vision_setup(cfg, eng):
    """The vision scene's 80 frames rendered on the card, each stream's fixed
    pixel noise (σ 0.01, bench.py:278-280) added, quantized to the 8-bit
    lattice (the bench's camera ADC, bench.py:293-300) and staged; the IMU
    noise of 64 Monte-Carlo streams."""
    import numpy as np
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator

    truth = simulator.load_scene(simulator.VISION_SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED))
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    w, h = cfg.cam_wh
    noise = 0.01 * torch.randn(BATCH, h, w, generator=g, device="cuda")
    drv = FusedVisionDriver(cfg, eng, BATCH)
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    t = time.time()
    ring = []
    for i in range(1, VISION_FRAMES + 1):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                    quat_2_rot(truth.gt_q[i]), truth.gt_p[i], R_ItoC, p_IinC,
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh))
        x = torch.clamp(img[None] + noise, 0.0, 1.0)
        ring.append(drv.stage_image(torch.round(x * 255.0) * (1.0 / 255.0)))
    torch.cuda.synchronize()
    mb = sum(r.numel() * r.element_size() for r in ring) / 1e6
    print(f"[vision] rendered and staged {VISION_FRAMES} frames x {BATCH} streams ({w}x{h}, {mb:.0f} MB ring, "
          f"{ring[0].dtype}) in {time.time() - t:.2f} s")
    info = drv.wire_guard_info or {}
    print(f"[vision] wire guard: wire={drv.vopts.img_wire} sampler={drv.vopts.klt.sampler} "
          f"u8_lossless={info.get('u8_lossless')} ({info.get('reason')})")
    imu = (truth.imu_t.cpu().numpy(), sim.imu_w.cpu().numpy(), sim.imu_a.cpu().numpy(), truth.cam_t_imu.cpu().numpy())
    return VisionRun(cfg, truth, imu, sim.gt_bg_cam[:, 0], sim.gt_ba_cam[:, 0], ring, drv.vopts.klt.sampler,
                     drv.vopts.img_wire)


def _imu_window(run: VisionRun, i: int, streams=slice(None)):
    """Frame i's IMU windows of the chosen streams, +inf padded (bench.py:195-205),
    from host copies (a read of a device scalar here would synchronize)."""
    import numpy as np

    W = run.cfg.tpu.max_imu_per_frame
    imu_t, imu_w, imu_a, cam_t = run.imu
    b = imu_w[streams].shape[0]
    s0 = int(run.truth.imu_window_start[i])
    m = min(W, imu_t.shape[0] - s0)
    it = np.full((b, W), np.inf)
    iw = np.zeros((b, W, 3))
    ia = np.zeros((b, W, 3))
    it[:, :m] = imu_t[s0:s0 + m]
    iw[:, :m] = imu_w[streams, s0:s0 + m]
    ia[:, :m] = imu_a[streams, s0:s0 + m]
    return it, iw, ia, np.full(b, float(cam_t[i]))


def vision_driver(run: VisionRun, eng, b: int, device, dtype):
    """A fresh driver, state, bank and tracker state for b streams."""
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import init_state_with_gt

    tr = run.truth
    # The bench spreads the detector's per-stream Delaunay calls over 4 threads (bench.py:261-264).
    drv = FusedVisionDriver(run.cfg, eng, b, sampler=run.sampler, img_wire=run.wire, plane_threads=4)
    st = init_state_with_gt(eng, run.cfg, t0=tr.cam_t_imu[0].expand(b), q0=tr.gt_q[0].expand(b, 4),
                            p0=tr.gt_p[0].expand(b, 3), v0=tr.gt_v[0].expand(b, 3), bg0=run.gt_bg0[:b],
                            ba0=run.gt_ba0[:b], dtype=dtype, device=device)
    bank = FeatureBank.create(run.cfg.tpu.max_features, eng.layout.max_clones, b, dtype, device)
    return drv, st, bank, drv.init_frontend()


def drive_vision():
    """Phase 6: the vision path at full width; returns (n_frames, launches, info)."""
    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.config import vision_config

    tag = "[vision]"
    t = time.time()
    cfg = vision_config()
    eng = VioEngine.from_config(cfg, device="cuda")
    run = vision_setup(cfg, eng)
    print(f"{tag} D={eng.layout.dim}; B={BATCH}; {VISION_FRAMES} frames; set-up {time.time() - t:.2f} s")

    # Warm-up: 12 frames; host synchronizations counted in steps 3-12 (the
    # first two make the libraries' handles), pulls counted by the driver.
    drv, st, bank, fev = vision_driver(run, eng, BATCH, "cuda", torch.float32)
    t = time.time()
    syncs, pulls = [], []
    for i in range(1, VISION_WARM + 1):
        n0 = drv.n_pulls
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if i >= 3:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                st, bank, fev, _ = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if i >= 3:
            syncs.append(sorted({str(w.message).splitlines()[0] for w in caught
                                 if "synchronizing CUDA operation" in str(w.message)}))
            pulls.append(drv.n_pulls - n0)
    torch.cuda.synchronize()
    print(f"{tag} warm-up {VISION_WARM} frames in {time.time() - t:.1f} s; steps 3-{VISION_WARM}: host "
          f"synchronizations other than the pull per step {[len(x) for x in syncs]} {sum(syncs, [])[:5]}; "
          f"packed pulls read per step {pulls}")
    if any(syncs) or pulls != [1] * len(pulls):
        raise RuntimeError("a vision step synchronizes with the host other than by its one packed pull")
    snapshot = (drv, st, bank, fev)

    # The timed run from a fresh state.
    drv, st, bank, fev = vision_driver(run, eng, BATCH, "cuda", torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    counters, pulls_ref, qs, ps, covs = [], [], [], [], []
    t = time.time()
    labelled = n_labels = 0
    for i in range(1, VISION_FRAMES + 1):
        fed = (drv._label_ids >= 0).sum(axis=1)
        labelled, n_labels = labelled + int((fed > 0).sum()), n_labels + int(fed.sum())
        st, bank, fev, out = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
        qs.append(out.q)
        ps.append(out.p)
        covs.append(out.cov_diag_imu[:, 0:6])
        if i > 1:
            counters.append(drv.last_counters.copy())
            pulls_ref.append(drv.last_pull[:2].copy())
    drv.flush_stream()
    torch.cuda.synchronize()
    wall = time.time() - t
    drv.close()
    counters.append(drv.last_counters.copy())
    pulls_ref.append(drv.last_pull[:2].copy())
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} {BATCH}x{VISION_FRAMES} stream-frames in {wall:.3f} s: {BATCH * VISION_FRAMES / wall:.2f} "
          f"stream-frames/s ({VISION_FRAMES / wall:.3f} frames/s per stream, {1e3 * wall / VISION_FRAMES:.1f} ms "
          f"per frame of {BATCH} streams)")
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != VISION_PER_FRAME[k] * VISION_FRAMES:
            raise RuntimeError(f"{k} launched {n} times over {VISION_FRAMES} frames, "
                               f"not {VISION_PER_FRAME[k]} per frame")
    import numpy as np

    cnt = np.stack(counters)                                   # [T, B, 9]
    for name, col in (("tracked", 5), ("RANSAC-kept", 6), ("new FAST", 7)):
        print(f"{tag} {name} per frame (mean over streams): " + " ".join(f"{v:.1f}" for v in cnt[:, :, col].mean(1)))
    q, p, cov = torch.stack(qs, 1), torch.stack(ps, 1), torch.stack(covs, 1)
    if not (torch.isfinite(q).all() and torch.isfinite(p).all() and torch.isfinite(st.cov).all()):
        raise RuntimeError("non-finite vision state")
    tr = run.truth
    m = rmse_nees(q.double(), p.double(), cov[..., 0:3].double(), cov[..., 3:6].double(),
                  tr.gt_q[1:VISION_FRAMES + 1], tr.gt_p[1:VISION_FRAMES + 1])
    rmse0 = m["rmse_pos"][0].item()
    n_planes, n_constr, n_init = int(cnt[:, :, 2].max()), int(cnt[:, :, 1].sum()), int(cnt[:, :, 0].sum())
    print(f"{tag} stream 0: rmse_pos={rmse0:.4f} m rmse_ori={m['rmse_ori_deg'][0].item():.4f} deg; mean over "
          f"{BATCH} streams rmse_pos={m['rmse_pos'].mean().item():.4f} m; in-state planes at most {n_planes}, "
          f"plane constraint updates {n_constr}, delayed-init candidates {n_init} (counted before the 2 s delay "
          f"gate, as in JAX); plane labels fed on {labelled} stream-frames ({n_labels} labels); "
          f"msckf features per frame (mean) {cnt[:, :, 3].mean():.2f}")
    if not rmse0 < 0.5:
        raise RuntimeError(f"stream 0 position RMSE {rmse0:.3f} m is not below 0.5 m")
    # The plane work this scene gives in 80 frames: the host detector's labels
    # reach the step and the delayed init finds candidates. No plane passes
    # the init gates after the 2 s delay in 80 frames, in the JAX package
    # too on the bench's own inputs (the plane witness of
    # tests/test_torch_fused.py, PERF.md §6); the plane path (phase 5)
    # holds plane states and constraint updates.
    if labelled == 0 or n_init == 0:
        raise RuntimeError("no plane label reached the step or no delayed-init candidate on any stream")

    # Streams 0-1 through the port on the CPU: frontend f32, filter f64.
    t = time.time()
    cpu_eng = VioEngine.from_config(run.cfg, device="cpu")
    cdrv, cst, cbank, cfev = vision_driver(run, cpu_eng, 2, "cpu", torch.float64)
    cq, cp, cpulls = [], [], []
    for i in range(1, VISION_REF + 1):
        cst, cbank, cfev, cout = cdrv.step_batch(cst, cbank, cfev, run.ring[i - 1][:2].cpu(),
                                                 *_imu_window(run, i, slice(0, 2)))
        cq.append(cout.q)
        cp.append(cout.p)
        if i > 1:
            cpulls.append(cdrv.last_pull.copy())
    cdrv.flush_stream()
    cdrv.close()
    cpulls.append(cdrv.last_pull.copy())
    card = np.stack(pulls_ref[:VISION_REF])[:, :, :-3]         # [T, 2, cap, 8]
    ref = np.stack(cpulls)[:, :, :-3]
    same = (card[..., 0] == ref[..., 0]) & (card[..., 3] == ref[..., 3])
    frac = same.mean()
    dp = (p[:2, :VISION_REF].double().cpu() - torch.stack(cp, 1)).abs().max().item()
    dq = (q[:2, :VISION_REF].double().cpu() - torch.stack(cq, 1)).abs().max().item()
    print(f"{tag} card f32 vs CPU (frontend f32, filter f64; {time.time() - t:.1f} s on the CPU), 2 streams x "
          f"{VISION_REF} frames: ids and valid equal on {int(same.sum())} of {same.size} slot-frames "
          f"({100 * frac:.2f}%); max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    if not (frac >= 0.99 and dp <= 1e-2 and dq <= 1e-3):
        raise RuntimeError("the card's vision run disagrees with the CPU reference")
    info = dict(stream_frames_per_s=BATCH * VISION_FRAMES / wall, wall_s=wall, n_frames=VISION_FRAMES,
                run=run, snapshot=snapshot)
    return VISION_FRAMES, launches, info


def profile_vision(info: dict, n: int = 5):
    """Where a vision frame's time goes: n frames after the warm-up, from its
    driver and state, under torch.profiler (``report_profile``)."""
    from torch.profiler import ProfilerActivity, profile

    tag = "[profile vision]"
    run = info["run"]
    drv, st, bank, fev = info["snapshot"]
    frame_wall_ms = 1e3 * info["wall_s"] / info["n_frames"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for i in range(VISION_WARM + 1, VISION_WARM + n + 1):
            st, bank, fev, _ = drv.step_batch(st, bank, fev, run.ring[i - 1], *_imu_window(run, i))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    drv.flush_stream()
    drv.close()
    report_profile(tag, prof, VISION_RANGES, VISION_WARM + 1, n, frame_wall_ms, wall_ms)


def drive_anchored():
    """Phase 5b, second part: anchored landmarks (OpenVINS's default SLAM
    representation) on MS-PT, 4 streams in f32, one ``run_sequence`` frame
    at a time until some active landmark has moved to a new anchor clone;
    returns (n_frames, launches, info)."""
    from ov_plane_tpu_torch.models.manager import VioEngine, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import ms_pl_config

    tag = "[anchored]"
    t = time.time()
    cfg = ms_pl_config()
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.feat_rep_slam = "ANCHORED_MSCKF_INVERSE_DEPTH"
    eng = VioEngine.from_config(cfg, device="cuda")
    b = ANCHOR_BATCH
    truth = simulator.load_scene(simulator.PLANE_SCENE_PATH, dtype=torch.float32, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), b, torch.Generator(device="cuda").manual_seed(SEED))
    state, bank = _fresh(eng, cfg, sim, b, "cuda", torch.float32)
    prev = None
    changes = inits = 0
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_run = time.time()
    for i in range(1, ANCHOR_FRAMES + 1):
        state, bank, out = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=1,
                                        start=i)
        cur = (state.slam_id.cpu(), state.slam_active.cpu(), state.slam_anchor_slot.cpu())
        inits += int(out.n_slam_init.sum())
        if prev is not None:
            kept = cur[1] & prev[1] & (cur[0] == prev[0])
            changes += int((kept & (cur[2] != prev[2])).sum())
        prev = cur
        if (cur[1] & (cur[2] < 0)).any():
            raise RuntimeError(f"frame {i}: an active anchored landmark has no anchor clone")
    wall = time.time() - t_run
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"{tag} launches: {launches}")
    for k, n in launches.items():
        if n != ANCHOR_PER_FRAME[k] * ANCHOR_FRAMES:
            raise RuntimeError(f"{k} launched {n} times over {ANCHOR_FRAMES} frames, "
                               f"not {ANCHOR_PER_FRAME[k]} per frame")
    if not (torch.isfinite(state.cov).all() and torch.isfinite(state.imu).all()
            and torch.isfinite(state.slam_p[state.slam_active]).all()):
        raise RuntimeError("non-finite state on the anchored run")
    print(f"{tag} MS-PT, {cfg.state.feat_rep_slam}, D={eng.layout.dim}, {b} streams x {ANCHOR_FRAMES} frames in "
          f"{time.time() - t:.1f} s: {inits} landmark inits, {changes} anchor changes of active landmarks, "
          f"{int(prev[1].sum())} landmarks active at the end, stream 0's anchors {prev[2][0].tolist()}")
    if inits == 0 or changes == 0:
        raise RuntimeError("no anchored landmark was initialized or moved to a new anchor")
    return ANCHOR_FRAMES, launches, dict(stream_frames_per_s=b * ANCHOR_FRAMES / wall, anchor_changes=changes)


def drive_tabletop():
    """Phase 6b: the fused path's plane update on the tabletop scene; returns
    (n_frames, launches, info)."""
    from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
    from ov_plane_tpu_torch.models.manager import VioEngine
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.ops.quat import quat_2_rot
    from ov_plane_tpu_torch.sim import simulator
    from ov_plane_tpu_torch.utils.config import tabletop_config

    tag = "[tabletop]"
    t = time.time()
    cfg = tabletop_config()
    eng = VioEngine.from_config(cfg, device="cuda")
    truth = simulator.load_scene(simulator.TABLETOP_SCENE_PATH, dtype=torch.float64, device="cuda")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), TABLETOP_BATCH,
                                torch.Generator(device="cuda").manual_seed(SEED + 3))
    n_frames = truth.cam_t.shape[0] - 1
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    frames = [render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, quat_2_rot(truth.gt_q[i]),
                                    truth.gt_p[i], R_ItoC, p_IinC, cfg.cam_intrinsics, tuple(cfg.cam_wh),
                                    **TABLETOP_LAYERS) for i in range(1, n_frames + 1)]
    torch.cuda.synchronize()
    # Float frames off the 8-bit lattice: the f32 wire and the exact sampler,
    # what the wire guard resolves them to (the frames are staged here).
    run = VisionRun(cfg, truth, (truth.imu_t.cpu().numpy(), sim.imu_w.cpu().numpy(), sim.imu_a.cpu().numpy(),
                                 truth.cam_t_imu.cpu().numpy()), sim.gt_bg_cam[:, 0], sim.gt_ba_cam[:, 0], None,
                    "mm", "f32")
    print(f"{tag} D={eng.layout.dim}; {n_frames} frames rendered on the card in {time.time() - t:.2f} s; "
          f"B={TABLETOP_BATCH}, f32")

    def drive(drv, st, bank, fev, b, on_card):
        rows = []
        for i in range(1, n_frames + 1):
            img = frames[i - 1].expand(b, -1, -1).contiguous()
            st, bank, fev, out = drv.step_batch(st, bank, fev, img if on_card else img.cpu(),
                                                *_imu_window(run, i, slice(0, b)))
            rows.append(torch.stack([out.n_plane_init, out.n_plane_constraints, out.n_planes], dim=1).cpu())
        drv.flush_stream()
        drv.close()
        return torch.stack(rows, dim=1), st                       # [b, T, 3]

    drv, st, bank, fev = vision_driver(run, eng, TABLETOP_BATCH, "cuda", torch.float32)
    kernels.reset_launch_counts()
    t = time.time()
    cnt, st = drive(drv, st, bank, fev, TABLETOP_BATCH, True)
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches, "kalman_downdate": kernels.kalman_downdate.launches}
    n_init, n_constr, n_planes = int(cnt[..., 0].sum()), int(cnt[..., 1].sum()), int(cnt[..., 2].max())
    in_state = int((cnt[..., 2].max(dim=1).values > 0).sum())
    print(f"{tag} {TABLETOP_BATCH}x{n_frames} stream-frames in {wall:.3f} s (wire {drv.vopts.img_wire}, sampler "
          f"{drv.vopts.klt.sampler}); launches {launches}; plane inits {n_init} (counted before the 2 s delay "
          f"gate), constraint updates {n_constr}, planes in the state at most {n_planes}, on {in_state} of "
          f"{TABLETOP_BATCH} streams")
    for k, n in launches.items():
        if n != TABLETOP_PER_FRAME[k] * n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames, "
                               f"not {TABLETOP_PER_FRAME[k]} per frame")
    if not (torch.isfinite(st.cov).all() and torch.isfinite(st.imu).all()):
        raise RuntimeError("non-finite tabletop state")
    if n_init < 1 or n_planes < 1 or n_constr < 1:
        raise RuntimeError("the fused path's plane update did not fire on the tabletop scene")

    # Stream 0 and the first other stream with a plane in the state through
    # the port on the CPU (frontend f32, filter f64), same inputs. Stream 0
    # must agree (its first plane enters the state at frame 42 on both); on
    # the other, an f32 gate that f64 does not take is printed.
    t = time.time()
    sel = [0] + [int(b) for b in (cnt[:, :, 2].max(dim=1).values > 0).nonzero()[:, 0] if b > 0][:1]
    imu_t, imu_w, imu_a, cam_t = run.imu
    sub = run._replace(imu=(imu_t, imu_w[sel], imu_a[sel], cam_t), gt_bg0=run.gt_bg0[sel], gt_ba0=run.gt_ba0[sel])
    cpu_eng = VioEngine.from_config(cfg, device="cpu")
    cref, _ = drive(*vision_driver(sub, cpu_eng, len(sel), "cpu", torch.float64), len(sel), False)
    same = []
    for j, b in enumerate(sel):
        card_b, cpu_b = cnt[b], cref[j]
        first = [int(c[:, 2].nonzero()[0]) + 1 if c[:, 2].any() else None for c in (card_b, cpu_b)]
        same.append(int((card_b == cpu_b).all(dim=1).sum()))
        print(f"{tag} stream {b}, card f32 vs CPU f64: first frame with a plane in the state {first[0]} vs "
              f"{first[1]}; (inits, constraints, planes) equal on {same[-1]} of {n_frames} frames")
        for f in range(35, n_frames):
            print(f"{tag}   frame {f + 1}: card {card_b[f].tolist()} CPU {cpu_b[f].tolist()}")
        if b == 0 and (first[0] is None or first[0] != first[1] or same[-1] < TABLETOP_MIN_EQUAL):
            raise RuntimeError(f"stream 0's plane counters disagree with the CPU f64 run: first plane at frame "
                               f"{first[0]} vs {first[1]}, equal on {same[-1]} of {n_frames} frames "
                               f"(at least {TABLETOP_MIN_EQUAL} needed)")
    print(f"{tag} CPU reference of streams {sel} in {time.time() - t:.1f} s")
    info = dict(stream_frames_per_s=TABLETOP_BATCH * n_frames / wall, wall_s=wall, n_frames=n_frames,
                streams=sel, counters_equal=same)
    return n_frames, launches, info


def main() -> int:
    t_start = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ov_plane_tpu_torch import native
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.torchenv import resolve_device

    resolve_device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])

    t = time.time()
    earlier_build = start_earlier_build(kernels)
    native.build("delaunay")          # g++, while nvcc builds the yardstick
    reports = kernels.build()
    earlier_kernel = earlier_build()
    print(f"[build] {len(reports)} kernels and the earlier one built with nvcc, the host Delaunay with g++, "
          f"in {time.time() - t:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = time_kernels(kernels, check_kernels(kernels), earlier_kernel)
    results = {}
    for spec in PATHS:
        t = time.time()
        n_frames, launches, info = drive_path(spec)
        profile_frames(spec, info)
        results[spec.name] = (n_frames, launches, info)
        print(f"[{spec.name}] phase took {time.time() - t:.1f} s")
    t = time.time()
    results["anchored"] = drive_anchored()
    print(f"[anchored] phase took {time.time() - t:.1f} s")
    t = time.time()
    results["vision"] = drive_vision()
    profile_vision(results["vision"][2])
    print(f"[vision] phase took {time.time() - t:.1f} s")
    t = time.time()
    results["tabletop"] = drive_tabletop()
    print(f"[tabletop] phase took {time.time() - t:.1f} s")

    meta = {
        "gram_reduce": ("ov_plane_tpu_torch/csrc/gram_reduce.cu",
                        "ov_plane_tpu/ops/pallas_kernels.py:138"),
        "kalman_downdate": ("ov_plane_tpu_torch/csrc/kalman_downdate.cu",
                            "ov_plane_tpu/ops/pallas_kernels.py:249"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        # Top level: the vision path (the system's main path) and LEAD's
        # shape; per path: its launches in its run and each of its shapes'
        # numbers.
        paths = {p: dict(launches=results[p][1][name], frames=results[p][0],
                         shapes=[dict(B=B, M=M, D=D, **rows[(name, (B, M, D))]) for B, M, D in shs[name]])
                 for p, shs in PATH_SHAPES.items()}
        out.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=results["vision"][1][name], shape=list(LEAD[name]), **rows[(name, LEAD[name])],
                        paths=paths))
    for p, (n_frames, launches, info) in results.items():
        print(f"[{p}] stream-frames/s {info['stream_frames_per_s']:.2f} over {n_frames} frames")
    print(f"[total] the whole script took {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
