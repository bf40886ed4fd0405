"""End-to-end simulated VIO run of one stream (counterpart of ``examples/run_sim.py``).

Builds the simulator scene, draws one noise instance (``torch.Generator``
seeded with ``sim.seed_measurements``), initializes from the ground truth,
replays the sequence through ``run_sequence`` twice (the second run gives
the steady-state rate) and prints RMSE/NEES (the reference's consistency
metrics, ROS1Visualizer.cpp:846-880) and per-segment diagnostics. On the
card the filter runs in float32 with information-form compression, on the
CPU in float64.

Usage:
  python -m ov_plane_tpu_torch.scripts.run_sim --duration 20 [--use-planes] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ov_plane_tpu_torch.eval.metrics import rmse_nees
from ov_plane_tpu_torch.scripts.run_sweep import run_variant
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.config import sim_config
from ov_plane_tpu_torch.utils.torchenv import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--freq-cam", type=float, default=0.0, help="override the simulated camera rate")
    ap.add_argument("--max-slam", type=int, default=0)
    ap.add_argument("--num-pts", type=int, default=80)
    ap.add_argument("--num-pts-plane", type=int, default=0)
    ap.add_argument("--max-features", type=int, default=256)
    ap.add_argument("--max-obs", type=int, default=160)
    ap.add_argument("--use-planes", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = sim_config()
    cfg.sim.traj_duration = args.duration
    if args.freq_cam > 0:
        cfg.sim.freq_cam = args.freq_cam
    cfg.state.max_slam_features = args.max_slam
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = args.use_planes
    cfg.state.use_plane_slam_feats = args.use_planes
    cfg.num_pts = args.num_pts
    cfg.num_pts_plane = args.num_pts_plane
    cfg.tpu.max_features = args.max_features
    cfg.tpu.max_obs_per_frame = args.max_obs

    print("[sim] building...", flush=True)
    t0 = time.time()
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device=dev)
    print(f"[sim] built in {time.time() - t0:.1f}s: {truth.feat_p.shape[0]} map feats, "
          f"{truth.cam_t_imu.shape[0]} frames, {truth.imu_t.shape[0]} imu samples", flush=True)
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), 1,
                                torch.Generator(device=dev).manual_seed(cfg.sim.seed_measurements))
    if dev.type == "cuda":
        sim = sim._replace(**{k: v.float() for k, v in sim._asdict().items()
                              if isinstance(v, torch.Tensor) and v.is_floating_point()})

    def timed():
        t = time.time()
        run = run_variant(cfg, 1, dev, sim=sim)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return run, time.time() - t

    print("[run] running...", flush=True)
    run, wall = timed()
    n_frames = run.t.shape[0]
    print(f"[run] {n_frames} frames in {wall:.1f}s ({n_frames / wall:.1f} fps incl. first-call set-up)", flush=True)
    _, wall2 = timed()
    print(f"[run] steady-state: {n_frames / wall2:.1f} fps", flush=True)

    outs = run.outs
    d = lambda x: x[0].double().cpu()  # noqa: E731
    m = rmse_nees(d(outs.q), d(outs.p), d(outs.cov_diag_imu)[:, 0:3], d(outs.cov_diag_imu)[:, 3:6],
                  torch.as_tensor(run.gt_q), torch.as_tensor(run.gt_p))
    print("metrics:", {k: float(v) for k, v in m.items()})
    for frac in (0.25, 0.5, 0.75, 1.0):
        i = int(n_frames * frac) - 1
        e_p = float(torch.linalg.vector_norm(d(outs.p)[i] - torch.as_tensor(run.gt_p[i])))
        print(f"  t={float(run.t[i]):6.2f}s pos_err={e_p:.4f}m "
              f"msckf_used={int(outs.n_msckf_used[0, i])} bank={int(outs.n_bank[0, i])} "
              f"clones={int(outs.n_clones[0, i])} slam={int(outs.n_slam[0, i])} planes={int(outs.n_planes[0, i])}")
    if not float(m["rmse_pos"]) < 1.0:
        raise RuntimeError(f"position RMSE {float(m['rmse_pos']):.3f} m diverged (not below 1.0 m)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
