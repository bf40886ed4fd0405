#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ov_plane_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is nonzero):

1. versions, the card's name and power limit, true-f32 matmul flags;
2. build the CUDA kernels from ``ov_plane_tpu_torch/csrc`` with nvcc;
3. check each kernel against its plain PyTorch version on the card, in f32
   and f64, at the filter's shapes and at unaligned ones, for tolerance and
   exact symmetry, and time kernel, plain version and one PyTorch library
   call (CUDA events, median of 50 launches after warm-up);
4. drive the main path: the bench's simulator scene, 64 Monte-Carlo streams
   from a seeded generator, ``VioEngine`` + ``run_sequence`` over every frame
   in f32; check the launch counts, finiteness, stream 0's accuracy and the
   agreement of two streams with an f64 CPU run of the port;
5. print the ``{"kernels": [...]}`` line, then the device line last.

Needs a CUDA card: without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import torch

BATCH = 64
SEED = 7
# f32 kernel vs plain: max|kernel − plain| ≤ TOL·max|plain| (the row sums run
# in another order); f64 the same at 1e-12.
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# Published dense peaks outside the tensor cores (NVIDIA data sheets):
# (memory bytes/s, f32 FLOP/s, f64 FLOP/s).
PEAKS = {"SXM": (3.35e12, 67e12, 34e12), "PCIe": (2.0e12, 51e12, 26e12), "NVL": (3.9e12, 60e12, 30e12)}


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def time_ms(fn, n: int = 50, warmup: int = 10) -> float:
    """Median device time of one call, from a pair of CUDA events per call."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check_kernels(kernels):
    """Phase 3: each kernel against its plain version; returns the JSON rows."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    name = torch.cuda.get_device_name(0)
    mem_bps, f32_flops, f64_flops = card_peaks(name)
    # (B, M, D): the main path's shapes first, then unaligned ones.
    shapes = {"gram_reduce": [(BATCH, 40 * (3 * 12 - 3), 93), (5, 300, 70)],
              "kalman_downdate": [(BATCH, 93, 93), (5, 300, 70)]}
    rows = {}
    for kname, shape_list in shapes.items():
        for dtype in (torch.float32, torch.float64):
            for (B, M, D) in shape_list:
                X = torch.randn(B, M, D, generator=g, device=dev, dtype=dtype)
                x = torch.randn(B, M, generator=g, device=dev, dtype=dtype)
                if kname == "gram_reduce":
                    args = (X, x)
                    out, vec = kernels.gram_reduce(*args)
                    ref, ref_vec = kernels.gram_reduce_ref(*args)
                else:
                    A = torch.randn(B, D, D, generator=g, device=dev, dtype=dtype)
                    P = A @ A.transpose(-1, -2) + D * torch.eye(D, device=dev, dtype=dtype)
                    args = (P, X, x)
                    out, vec = kernels.kalman_downdate(*args)
                    ref, ref_vec = kernels.kalman_downdate_ref(*args)
                torch.cuda.synchronize()
                err = max((out - ref).abs().max().item(), (vec - ref_vec).abs().max().item())
                scale = max(ref.abs().max().item(), ref_vec.abs().max().item())
                sym = torch.equal(out, out.transpose(-1, -2))
                print(f"[check] {kname} {str(dtype)[6:]} B={B} M={M} D={D}: max_abs_err={err:.3e} "
                      f"(limit {TOL[dtype] * scale:.3e}) bitwise_symmetric={sym}")
                if not (err <= TOL[dtype] * scale and sym and torch.isfinite(out).all()):
                    raise RuntimeError(f"{kname} disagrees with its plain version at {dtype} {(B, M, D)}")
                if dtype != torch.float32 or (B, M, D) != shape_list[0]:
                    continue
                # Timing at the main path's f32 shapes.
                if kname == "gram_reduce":
                    Xa = torch.cat([X, x[..., None]], dim=-1)
                    lib = lambda: torch.bmm(X.transpose(-1, -2), Xa)  # [HᵀH | Hᵀr]  # noqa: E731
                    bytes_ = 4 * (B * M * D + B * M + B * D * D + B * D)
                else:
                    Xa = torch.cat([X, -x[..., None]], dim=-1)
                    Pa = torch.cat([P, torch.zeros(B, D, 1, device=dev)], dim=-1)
                    lib = lambda: torch.baddbmm(Pa, X.transpose(-1, -2), Xa, alpha=-1.0)  # [P−WᵀW | Wᵀu]  # noqa: E731
                    bytes_ = 4 * (2 * B * D * D + B * M * D + B * M + B * D)
                flops = 2 * B * M * (D * (D + 1) // 2 + D)  # upper triangle + the folded column
                t_bytes, t_ops = bytes_ / mem_bps * 1e3, flops / f32_flops * 1e3
                calls_before = getattr(kernels, kname).launches
                k_ms = time_ms(lambda: getattr(kernels, kname)(*args))
                getattr(kernels, kname).launches = calls_before
                p_ms = time_ms(lambda: getattr(kernels, kname + "_ref")(*args))
                l_ms = time_ms(lib)
                rows[kname] = dict(max_abs_err=err, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
                                   bound_ms=max(t_bytes, t_ops),
                                   bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=l_ms)
                print(f"[time] {kname} f32 B={B} M={M} D={D}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"library {l_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
                      f"({rows[kname]['bound_by']}; {bytes_ / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return rows


def drive_main_path():
    """Phase 4: the port's main path at the bench's full width; returns (n_frames, info)."""
    from ov_plane_tpu_torch import convert  # noqa: F401  (package import check)
    from ov_plane_tpu_torch.eval.metrics import rmse_nees
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.sim.simulator import apply_noise, load_scene, noise_params
    from ov_plane_tpu_torch.utils.config import slice_config

    cfg = slice_config()
    dev, dtype = "cuda", torch.float32
    t = time.time()
    truth = load_scene(dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sim = apply_noise(truth, noise_params(cfg), BATCH, gen)
    eng = VioEngine.from_config(cfg, device=dev)
    n_frames = sim.cam_t.shape[0] - 1
    print(f"[main] scene {n_frames + 1} frames, {sim.imu_t.shape[0]} IMU samples, "
          f"{truth.obs_id.shape[1]} observation slots; D={eng.layout.dim}; B={BATCH}; "
          f"set-up {time.time() - t:.2f} s")

    def fresh(s, b, device, dt):
        st = init_state_with_gt(eng, cfg, t0=s.cam_t_imu[0].expand(b), q0=s.gt_q[0].expand(b, 4),
                                p0=s.gt_p[0].expand(b, 3), v0=s.gt_v[0].expand(b, 3),
                                bg0=s.gt_bg_cam[:b, 0], ba0=s.gt_ba_cam[:b, 0], dtype=dt, device=device)
        return st, FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, b, dt, device)

    # Warm-up (library handles, allocator), then the step's synchronizations
    # are counted over a few frames that include updates, then the counted run.
    state, bank = fresh(sim, BATCH, dev, dtype)
    state, bank, _ = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=3)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=9)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "synchronizing CUDA operation" in str(w.message)})
    print(f"[main] host synchronizations inside 9 steps: {len(syncs)} {syncs[:5]}")
    if syncs:
        raise RuntimeError("the step synchronizes with the host")
    state, bank = fresh(sim, BATCH, dev, dtype)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.time()
    state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {"gram_reduce": kernels.gram_reduce.launches,
                "kalman_downdate": kernels.kalman_downdate.launches}
    print(f"[main] {BATCH}x{n_frames} stream-frames in {wall:.3f} s: "
          f"{BATCH * n_frames / wall:.1f} stream-frames/s ({n_frames / wall:.2f} frames/s per stream)")
    print(f"[main] launches: {launches}")
    for k, n in launches.items():
        if n != n_frames:
            raise RuntimeError(f"{k} launched {n} times over {n_frames} frames")

    for name, v in outs._asdict().items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise RuntimeError(f"non-finite output {name}")
    if not (torch.isfinite(state.cov).all() and torch.isfinite(state.imu).all()):
        raise RuntimeError("non-finite final state")
    m = rmse_nees(outs.q.double(), outs.p.double(), outs.cov_diag_imu[..., 0:3].double(),
                  outs.cov_diag_imu[..., 3:6].double(), sim.gt_q[1:].double(), sim.gt_p[1:].double())
    rmse0 = m["rmse_pos"][0].item()
    print(f"[main] stream 0: rmse_pos={rmse0:.4f} m rmse_ori={m['rmse_ori_deg'][0].item():.4f} deg; "
          f"mean over {BATCH} streams: rmse_pos={m['rmse_pos'].mean().item():.4f} m "
          f"rmse_ori={m['rmse_ori_deg'].mean().item():.4f} deg "
          f"nees_ori={m['nees_ori'].mean().item():.3f} nees_pos={m['nees_pos'].mean().item():.3f}; "
          f"msckf features used per frame (mean) {outs.n_msckf_used.float().mean().item():.2f}")
    if not rmse0 < 0.5:
        raise RuntimeError(f"stream 0 position RMSE {rmse0:.3f} m is not below 0.5 m")

    # Reference on a small input: two of the streams through the port on the
    # CPU in f64 (plain kernel versions), against the card's f32 run.
    n_ref = 30
    sim_cpu = sim._replace(**{k: v[:2].double().cpu() for k, v in sim._asdict().items()
                              if k in ("imu_w", "imu_a", "obs_uv", "gt_bg", "gt_ba", "gt_bg_cam", "gt_ba_cam")},
                           **{k: v.double().cpu() if v.is_floating_point() else v.cpu()
                              for k, v in sim._asdict().items()
                              if k in ("imu_t", "cam_t", "cam_t_imu", "obs_id", "obs_plane", "gt_q", "gt_p", "gt_v")})
    eng_cpu = VioEngine.from_config(cfg, device="cpu")
    st_c, bk_c = fresh(sim_cpu, 2, "cpu", torch.float64)
    _, _, ref = run_sequence(eng_cpu, st_c, bk_c, sim_cpu, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_ref)
    dp = (outs.p[:2, :n_ref].double().cpu() - ref.p).abs().max().item()
    dq = (outs.q[:2, :n_ref].double().cpu() - ref.q).abs().max().item()
    print(f"[main] card f32 vs CPU f64, 2 streams x {n_ref} frames: max|dp|={dp:.3e} m max|dq|={dq:.3e}")
    if not (dp < 1e-2 and dq < 1e-3):
        raise RuntimeError("the card's run disagrees with the CPU f64 reference")
    return n_frames, launches, dict(stream_frames_per_s=BATCH * n_frames / wall, wall_s=wall)


def profile_frames(frame_wall_ms: float, n: int = 5):
    """Where a frame's time goes (torch.profiler over a short steady window):
    device kernel time and kernel count per frame, the device's idle share of
    an unprofiled frame (frame_wall_ms, from the main run), and the host time
    of each stage of the step (inflated by the profiler's own overhead)."""
    from ov_plane_tpu_torch.models.feature_bank import FeatureBank
    from ov_plane_tpu_torch.models.manager import STAGES, VioEngine, init_state_with_gt, run_sequence
    from ov_plane_tpu_torch.sim.simulator import apply_noise, load_scene, noise_params
    from ov_plane_tpu_torch.utils.config import slice_config
    from torch.profiler import ProfilerActivity, profile

    cfg = slice_config()
    truth = load_scene(dtype=torch.float32, device="cuda")
    sim = apply_noise(truth, noise_params(cfg), BATCH, torch.Generator(device="cuda").manual_seed(SEED))
    eng = VioEngine.from_config(cfg, device="cuda")
    st = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(BATCH), q0=sim.gt_q[0].expand(BATCH, 4),
                            p0=sim.gt_p[0].expand(BATCH, 3), v0=sim.gt_v[0].expand(BATCH, 3),
                            bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], dtype=torch.float32)
    bk = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, BATCH, torch.float32, "cuda")
    st, bk, _ = run_sequence(eng, st, bk, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run_sequence(eng, st, bk, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    # Raw events, not key_averages(): a stage's host range and its device
    # annotation share one name and would be merged into one average.
    events = prof.events()
    kern = [e for e in events if e.device_type.name == "CUDA" and e.name not in STAGES]
    busy_ms = sum(e.device_time_total for e in kern) / 1e3 / n
    if busy_ms <= 0:
        print("[profile] the profiler recorded no device time: device idle share not measured")
        return
    print(f"[profile] per frame over {n} frames: {len(kern) / n:.0f} kernels, device busy {busy_ms:.2f} ms; "
          f"unprofiled frame {frame_wall_ms:.2f} ms -> device idle {100 * (1 - busy_ms / frame_wall_ms):.1f}%; "
          f"profiled frame {wall_ms / n:.2f} ms")
    host = dict.fromkeys(STAGES, 0.0)
    for e in events:
        if e.name in host and e.device_type.name == "CPU":
            host[e.name] += e.cpu_time_total / 1e3 / n
    print("[profile] host ms per frame by stage (profiled): " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time_total, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]:
        print(f"[profile]   {t / 1e3 / n:8.3f} ms/frame  x{c // n:5d}  {name[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    from ov_plane_tpu_torch.ops import kernels
    from ov_plane_tpu_torch.utils.torchenv import resolve_device

    resolve_device("cuda")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])

    t = time.time()
    reports = kernels.build()
    print(f"[build] {len(reports)} kernels built with nvcc in {time.time() - t:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = check_kernels(kernels)
    n_frames, launches, info = drive_main_path()
    profile_frames(1e3 * info["wall_s"] / n_frames)

    meta = {
        "gram_reduce": ("ov_plane_tpu_torch/csrc/gram_reduce.cu",
                        "ov_plane_tpu/ops/pallas_kernels.py:138"),
        "kalman_downdate": ("ov_plane_tpu_torch/csrc/kalman_downdate.cu",
                            "ov_plane_tpu/ops/pallas_kernels.py:249"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        out.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=launches[name], **rows[name]))
    print(f"[main] stream-frames/s {info['stream_frames_per_s']:.2f}")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
