"""Algorithm-variant sweep over simulated sequences (counterpart of
``scripts/run_sweep.py``): the reference's dataset-regression protocol
(results/run_simulation.sh:73-99 × results/sim_general/plot.sh) as one script.

Variants follow the reference naming (results/run_ros_eth.sh:86-99):

  M-PT    mono, points only (MSCKF)
  MS-PT   mono + SLAM landmarks
  M-PL    mono + CP planes & point-on-plane constraints
  MS-PL   mono + SLAM + planes

Each variant runs its Monte-Carlo seeds as one batch of B = seeds streams
through ``VioEngine`` + ``run_sequence`` on the scene that ``build_sim``
makes (the reference runs twenty sequential roslaunch processes). On the
card the filter runs in float32 with information-form compression, as the
JAX script runs on an accelerator; on the CPU in float64. The noise of all
streams comes from one ``torch.Generator`` seeded with 5. Per-seed TUM
trajectories are written in the ov_eval folder layout:

  <out>/truths/<seq>.txt
  <out>/algorithms/<variant>/<seq>/estimate_<k>.txt

and the comparison table of ``ov_eval error_comparison`` is printed at the end.

Usage:
  python -m ov_plane_tpu_torch.scripts.run_sweep --seeds 10 --duration 30 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ov_plane_tpu_torch.eval.io import write_tum
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
from ov_plane_tpu_torch.scripts import ov_eval
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.config import sim_config
from ov_plane_tpu_torch.utils.torchenv import resolve_device

VARIANTS = {
    # name -> (max_slam, use_planes)
    "M-PT": (0, False),
    "MS-PT": (12, False),
    "M-PL": (0, True),
    "MS-PL": (12, True),
}
NOISE_SEED = 5


def make_config(duration, traj_path, max_slam, use_planes):
    cfg = sim_config()
    cfg.sim.traj_duration = duration
    cfg.sim.traj_path = traj_path
    cfg.state.max_slam_features = max_slam
    cfg.state.use_plane_constraint = use_planes
    cfg.state.use_plane_slam_feats = use_planes
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 40
    cfg.num_pts_plane = 40 if use_planes else 0
    cfg.tpu.max_features = 192
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    return cfg


class VariantRun(NamedTuple):
    """One variant's batched run: frame times t [F] and the estimates p [S, F, 3],
    q [S, F, 4] against the truth gt_p [F, 3], gt_q [F, 4] (numpy float64),
    with the run's outputs, its noisy scene, engine and final state."""
    t: np.ndarray
    p: np.ndarray
    q: np.ndarray
    gt_p: np.ndarray
    gt_q: np.ndarray
    outs: object
    sim: simulator.SimData
    eng: VioEngine
    state: object


def noisy_scene(cfg, seeds: int, device="cuda", truth: simulator.SimTruth | None = None) -> simulator.SimData:
    """``seeds`` noise draws of the configuration's scene (built by
    ``build_sim`` unless given), drawn in float64 from
    ``torch.Generator(device).manual_seed(5)``, in the filter's type: float32
    on the card, float64 on the CPU."""
    dev = resolve_device(device)
    if truth is None:
        truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device=dev)
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), seeds,
                                torch.Generator(device=dev).manual_seed(NOISE_SEED))
    dt = torch.float32 if dev.type == "cuda" else torch.float64
    return sim._replace(**{k: v.to(dt) for k, v in sim._asdict().items()
                           if isinstance(v, torch.Tensor) and v.is_floating_point()})


def run_variant(cfg, seeds: int, device="cuda", sim: simulator.SimData | None = None,
                n_frames: int | None = None) -> VariantRun:
    """The batched replay of ``seeds`` noise draws (:func:`noisy_scene`
    unless ``sim`` is given) over the scene's frames (its first ``n_frames``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cfg.tpu.use_info_compression = True
    if sim is None:
        sim = noisy_scene(cfg, seeds, dev)
    dt = sim.imu_w.dtype
    eng = VioEngine.from_config(cfg, device=dev)
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(seeds), q0=sim.gt_q[0].expand(seeds, 4),
                               p0=sim.gt_p[0].expand(seeds, 3), v0=sim.gt_v[0].expand(seeds, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], dtype=dt, device=dev)
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, seeds, dt, dev)
    state, _, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame, n_frames=n_frames)
    F = outs.p.shape[1]

    def host(x):
        return x.detach().to(torch.float64).cpu().numpy()

    return VariantRun(t=host(sim.cam_t_imu[1:F + 1]), p=host(outs.p), q=host(outs.q),
                      gt_p=host(sim.gt_p[1:F + 1]), gt_q=host(sim.gt_q[1:F + 1]),
                      outs=outs, sim=sim, eng=eng, state=state)


def write_variant(out: str, name: str, seq_name: str, run: VariantRun, truth: bool = False):
    """The variant's estimates (and with ``truth`` the ground truth) as TUM files."""
    if truth:
        write_tum(os.path.join(out, "truths", seq_name + ".txt"), run.t, run.gt_p, run.gt_q)
    seq_dir = os.path.join(out, "algorithms", name, seq_name)
    os.makedirs(seq_dir, exist_ok=True)
    for k in range(run.p.shape[0]):
        write_tum(os.path.join(seq_dir, f"estimate_{k}.txt"), run.t, run.p[k], run.q[k])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "ovp_sweep"))
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--seq", default="", help="trajectory txt to replay "
                    "(e.g. the reference's data/udel_arl.txt); procedural room scan if empty")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    seq_name = os.path.splitext(os.path.basename(args.seq))[0] if args.seq else "room_scan"
    os.makedirs(os.path.join(args.out, "truths"), exist_ok=True)
    names = [v.strip() for v in args.variants.split(",")]
    for i, name in enumerate(names):
        max_slam, use_planes = VARIANTS[name]
        cfg = make_config(args.duration, args.seq, max_slam, use_planes)
        print(f"[sweep] {name}: {args.seeds} seeds on {seq_name} (slam={max_slam}, planes={use_planes})", flush=True)
        write_variant(args.out, name, seq_name, run_variant(cfg, args.seeds, args.device), truth=i == 0)

    # The comparison table (plot.sh analogue) through the ov_eval command.
    ov_eval.main(["error_comparison", os.path.join(args.out, "truths"),
                  *(os.path.join(args.out, "algorithms", v) for v in names), "--device", args.device])
    return 0


if __name__ == "__main__":
    sys.exit(main())
