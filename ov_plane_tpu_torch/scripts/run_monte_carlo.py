"""Monte-Carlo consistency sweep: N seeds as one batch of streams (counterpart
of ``examples/run_monte_carlo.py``).

The reference's 20-seed simulation sweeps (results/run_simulation.sh:73-99,
twenty sequential roslaunch runs) as one batched ``run_sequence`` over
noise draws of one ``build_sim`` scene. Reports the mean RMSE, the average
NEES with the diagonal covariance and with the full 3×3 marginal blocks
(ROS1Visualizer.cpp:850-852), optionally its trend over time segments, and
two verdicts: NEES consistent (both means in (0.05, 9), dim = 3) and the
RMSE bar (0.2 m plus 0.2 mm per second of trajectory). On the card the
filter runs in float32 with information-form compression, on the CPU in
float64; the metrics are taken in float64.

Usage:
  python -m ov_plane_tpu_torch.scripts.run_monte_carlo --seeds 20 --duration 20 [--use-planes]
         [--max-slam N] [--trend N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ov_plane_tpu_torch.eval.metrics import nees_full, ori_pos_errors, rmse_nees
from ov_plane_tpu_torch.scripts.run_sweep import make_config, noisy_scene, run_variant
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.torchenv import resolve_device


def mc_metrics(outs, gt_q, gt_p) -> dict:
    """Per-seed RMSE and NEES of a batched run's outputs (q, p [S, F, ...],
    cov_diag_imu, cov_ori_blk, cov_pos_blk) against the truth gt_q, gt_p [F, ...],
    in float64: ``rmse_ori_deg``, ``rmse_pos``, ``nees_ori``, ``nees_pos``
    [S], and the per-frame NEES series [S, F] in both conventions
    (``nees_ori_t``, ``nees_pos_t`` diagonal; ``neesf_ori_t``, ``neesf_pos_t``
    the full marginal blocks)."""
    d = lambda x: torch.as_tensor(x).to(torch.float64)  # noqa: E731
    q, p, cov = d(outs.q), d(outs.p), d(outs.cov_diag_imu)
    gt_q, gt_p = d(gt_q).to(q.device), d(gt_p).to(q.device)
    m = rmse_nees(q, p, cov[..., 0:3], cov[..., 3:6], gt_q, gt_p)
    e_th, e_p = ori_pos_errors(q, p, gt_q, gt_p)
    S, F = q.shape[:2]
    m["nees_ori_t"] = torch.sum(e_th**2 / torch.clamp(cov[..., 0:3], min=1e-18), dim=-1)
    m["nees_pos_t"] = torch.sum(e_p**2 / torch.clamp(cov[..., 3:6], min=1e-18), dim=-1)
    m["neesf_ori_t"] = nees_full(e_th.reshape(-1, 3), d(outs.cov_ori_blk).reshape(-1, 3, 3)).reshape(S, F)
    m["neesf_pos_t"] = nees_full(e_p.reshape(-1, 3), d(outs.cov_pos_blk).reshape(-1, 3, 3)).reshape(S, F)
    return {k: v.cpu().numpy() for k, v in m.items()}


def verdicts(m: dict, duration: float):
    """(NEES consistent, RMSE OK): both mean NEES in (0.05, 9); the mean
    position RMSE below 0.2 m plus 0.2 mm per second of trajectory."""
    nees_ok = bool(0.05 < m["nees_ori"].mean() < 9.0 and 0.05 < m["nees_pos"].mean() < 9.0)
    return nees_ok, bool(m["rmse_pos"].mean() < 0.2 + 2e-4 * duration)


def report(m: dict, t_cam: np.ndarray, trend: int = 0, dynamics=None) -> str:
    """The printout of the JAX script: means, full-block NEES, the optional
    trend over ``trend`` time segments, and the verdicts."""
    lines = [f"  RMSE ori: mean {m['rmse_ori_deg'].mean():.3f} deg (std {m['rmse_ori_deg'].std():.3f})",
             f"  RMSE pos: mean {m['rmse_pos'].mean():.3f} m   (std {m['rmse_pos'].std():.3f})",
             f"  NEES ori: mean {m['nees_ori'].mean():.2f}  | NEES pos: mean {m['nees_pos'].mean():.2f}  (dim = 3)",
             f"  NEES (full 3x3 block, reference convention ROS1Visualizer.cpp:850-852): "
             f"ori {m['neesf_ori_t'].mean():.2f} | pos {m['neesf_pos_t'].mean():.2f}"]
    if trend > 0:
        # Seed-averaged per-frame NEES in time segments: a consistent FEJ
        # filter stays flat near dim; a climbing curve is optimism growing.
        nth, npos, nfth, nfpos = (m[k].mean(axis=0) for k in ("nees_ori_t", "nees_pos_t", "neesf_ori_t",
                                                               "neesf_pos_t"))
        edges = np.linspace(0, nth.shape[0], trend + 1).astype(int)
        lines.append("  NEES trend (seed-averaged, per time segment; diag | full-block):")
        for a, b in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            line = (f"    t=[{t_cam[a]:6.1f},{t_cam[b - 1]:6.1f}]s  ori {nth[a:b].mean():5.2f}"
                    f"  pos {npos[a:b].mean():5.2f}  | full ori {nfth[a:b].mean():5.2f}  pos {nfpos[a:b].mean():5.2f}")
            if dynamics is not None:
                it, wt, at = dynamics
                sel = (it >= t_cam[a]) & (it <= t_cam[b - 1])
                if sel.any():
                    line += (f"   |w| mean {wt[sel].mean():5.2f} max {wt[sel].max():5.2f} rad/s"
                             f"  |a| mean {at[sel].mean():5.2f} max {at[sel].max():6.2f} m/s^2")
            lines.append(line)
    nees_ok, rmse_ok = verdicts(m, float(t_cam[-1] - t_cam[0]))
    lines.append(("NEES CONSISTENT" if nees_ok else "NEES INCONSISTENT")
                 + (" | RMSE OK" if rmse_ok else " | RMSE HIGH"))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--use-planes", action="store_true")
    ap.add_argument("--max-slam", type=int, default=0)
    ap.add_argument("--seq", default="", help="trajectory txt (e.g. the reference's data/udel_arl.txt) "
                    "instead of the built-in room scan")
    ap.add_argument("--trend", type=int, default=0, metavar="N",
                    help="also print the NEES trend over N time segments (seed-averaged per-frame NEES)")
    ap.add_argument("--traj-start", type=float, default=0.0,
                    help="skip this many seconds of a --seq trajectory before the replay")
    ap.add_argument("--no-fej", action="store_true", help="disable first-estimates Jacobians")
    ap.add_argument("--filter-gyro-scale", type=float, default=1.0,
                    help="scale the filter's assumed gyro noise (sigma_w, sigma_wb) while the simulated "
                         "noise stays at the true level")
    ap.add_argument("--dynamics", action="store_true",
                    help="print per-segment trajectory dynamics (|w|, |a|) next to the NEES trend")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # The ladder's configuration (the JAX script sets the same values).
    cfg = make_config(args.duration, args.seq, args.max_slam, args.use_planes)
    if args.seq:
        cfg.sim.traj_start = args.traj_start
    if args.no_fej:
        cfg.state.do_fej = False

    print("[mc] building sim truth...", flush=True)
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device=dev)
    sim = noisy_scene(cfg, args.seeds, dev, truth)
    if args.filter_gyro_scale != 1.0:
        # The noise is drawn at the true level above; only the filter's model changes.
        cfg.imu_noises.sigma_w *= args.filter_gyro_scale
        cfg.imu_noises.sigma_wb *= args.filter_gyro_scale
    print(f"[mc] running {args.seeds} seeds as one batch...", flush=True)
    t0 = time.time()
    run = run_variant(cfg, args.seeds, dev, sim=sim)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    m = mc_metrics(run.outs, truth.gt_q[1:], truth.gt_p[1:])
    print(f"[mc] {args.seeds} runs in {wall:.1f}s ({args.seeds * run.t.shape[0] / wall:.0f} frames/s aggregate)")
    dynamics = None
    if args.dynamics:
        # Noiseless angular rate and specific force by camera-time bucket.
        dynamics = (truth.imu_t.double().cpu().numpy(),
                    torch.linalg.vector_norm(truth.imu_w_true.double(), dim=1).cpu().numpy(),
                    torch.linalg.vector_norm(truth.imu_a_true.double(), dim=1).cpu().numpy())
    print(report(m, run.t, args.trend, dynamics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
