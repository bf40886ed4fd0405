"""Export a simulated sequence as a EuRoC/ASL folder (counterpart of
``scripts/make_synth_asl.py``).

Writes ``<out>/mav0/{imu0,cam0,state_groundtruth_estimate0}``: the IMU with
noise drawn by ``sim.simulator.apply_noise`` from ``--seed``, the camera
frames rendered on the device and stored as 8-bit gray PNGs (``eval.png``),
and the ground truth at each frame, so that ``python -m
ov_plane_tpu_torch.scripts.run_euroc --data <out> --sim-calib`` (the
ros1_serial_msckf counterpart) replays it, static and dynamic
initialization included.

The scene is built by the port's ``build_sim`` from the flags, as the JAX
writer builds it (a ``--traj-kind`` trajectory of ``--duration`` seconds,
``--num-pts`` free and ``--num-pts-plane`` on-plane points, the cuboid room
``--room-margin`` beyond the trajectory, the simulator's EuRoC camera at
752×480 radtan). Frames are ``frontend.synthetic.render_frame``'s feature
blobs on a dark background, or with ``--textured`` the raycast room with
procedural plane textures, the blobs drawn over it unless ``--no-blobs``.
``--scene tabletop|vision`` exports a committed scene instead (the 10 s
tabletop, 127 frames, whose planes enter the filter's state and where
dynamic initialization succeeds, or the vision room, 98 frames), textured
without blobs.

Usage:
  python -m ov_plane_tpu_torch.scripts.make_synth_asl --out DIR [--duration 15] [--num-pts 60]
         [--num-pts-plane 0] [--textured [--no-blobs]] [--traj-kind room_scan] [--frames N]
         [--seed 7] [--no-gt] [--skip-start S] [--device cuda|cpu]
  python -m ov_plane_tpu_torch.scripts.make_synth_asl --out DIR --scene tabletop [--frames N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ov_plane_tpu_torch.eval import png
from ov_plane_tpu_torch.frontend.synthetic import render_frame, render_frame_textured
from ov_plane_tpu_torch.ops.quat import quat_2_rot
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.config import sim_config
from ov_plane_tpu_torch.utils.torchenv import resolve_device

# Each committed scene's file and the texture layers its JAX test renders it with.
TABLETOP_LAYERS = dict(texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))   # tests/test_fused_planes.py
SCENES = {
    "tabletop": ("TABLETOP_REPLAY_SCENE_PATH", TABLETOP_LAYERS),
    "vision": ("VISION_SCENE_PATH", dict(texture_cell=0.22, speckle_cells=(0.15,))),
}


def write_scene(out: str, cfg, truth: simulator.SimTruth, render, frames: int = 0, seed: int = 7, gt: bool = True,
                skip_start: float = 0.0) -> dict:
    """Write the ASL folder of the noiseless scene ``truth`` with one noise
    draw of ``cfg``'s magnitudes; ``render(R_GtoI, p_IinG)`` gives the
    [H, W] image in [0, 1] of a camera pose. Frames and IMU samples before
    ``skip_start`` seconds are left out; ``frames`` > 0 caps the frames
    written. Returns {"frames", "imu"}."""
    dev = truth.imu_t.device
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), 1, torch.Generator(device=dev).manual_seed(seed))
    base = os.path.join(out, "mav0")
    os.makedirs(os.path.join(base, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(base, "cam0", "data"), exist_ok=True)

    imu_t = truth.imu_t.cpu().numpy()
    keep = imu_t >= skip_start
    imu_w, imu_a = sim.imu_w[0].cpu().numpy(), sim.imu_a[0].cpu().numpy()
    with open(os.path.join(base, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        for t, w, a in zip(imu_t[keep], imu_w[keep], imu_a[keep]):
            f.write(f"{int(t * 1e9)}," + ",".join(f"{v:.9f}" for v in (*w, *a)) + "\n")

    cam_t = truth.cam_t_imu.cpu().numpy()
    rows = [k for k in range(len(cam_t)) if cam_t[k] >= skip_start]
    rows = rows if frames <= 0 else rows[:frames]
    with open(os.path.join(base, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for k in rows:
            img = render(quat_2_rot(truth.gt_q[k]), truth.gt_p[k])
            name = f"{int(cam_t[k] * 1e9)}.png"
            # Truncated to 8 bits as the JAX writer stores (img * 255).astype(uint8).
            png.write_gray(os.path.join(base, "cam0", "data", name), (img * 255.0).to(torch.uint8).cpu().numpy())
            f.write(f"{int(cam_t[k] * 1e9)},{name}\n")

    if gt:
        gdir = os.path.join(base, "state_groundtruth_estimate0")
        os.makedirs(gdir, exist_ok=True)
        gq, gp, gv = truth.gt_q.cpu().numpy(), truth.gt_p.cpu().numpy(), truth.gt_v.cpu().numpy()
        bg, ba = sim.gt_bg_cam[0].cpu().numpy(), sim.gt_ba_cam[0].cpu().numpy()
        with open(os.path.join(gdir, "data.csv"), "w") as f:
            f.write("#timestamp,p(3),q_wxyz(4),v(3),bw(3),ba(3)\n")
            for k in rows:
                q = gq[k]   # JPL q_GtoI shares its components with Hamilton q_ItoG: reorder only
                row = [int(cam_t[k] * 1e9), *gp[k], q[3], q[0], q[1], q[2], *gv[k], *bg[k], *ba[k]]
                f.write(",".join(str(v) if i == 0 else f"{v:.9f}" for i, v in enumerate(row)) + "\n")
    return {"frames": len(rows), "imu": int(keep.sum())}


def _camera(cfg, dev):
    f64 = torch.float64
    return (quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=f64, device=dev)),
            torch.tensor(cfg.cam_extrinsics[4:7], dtype=f64, device=dev))


def write_asl(out: str, scene: str = "tabletop", frames: int = 0, seed: int = 7, gt: bool = True,
              device="cuda") -> dict:
    """Write the ASL folder of a committed scene (``SCENES``), textured
    without blobs; returns {"frames", "imu", "seconds"}."""
    dev = resolve_device(device)
    t0 = time.time()
    path_attr, layers = SCENES[scene]
    cfg = sim_config()
    truth = simulator.load_scene(getattr(simulator, path_attr), dtype=torch.float64, device=dev)
    R_ItoC, p_IinC = _camera(cfg, dev)

    def render(R_GtoI, p_IinG):
        return render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, R_GtoI, p_IinG,
                                     R_ItoC, p_IinC, cfg.cam_intrinsics, tuple(cfg.cam_wh), **layers)

    info = write_scene(out, cfg, truth, render, frames, seed, gt)
    return {**info, "seconds": time.time() - t0}


def synth_config(duration=15.0, num_pts=60, num_pts_plane=0, freq_cam=20.0, room_margin=1.0, traj_kind="room_scan",
                 world_offset=(0.0, 0.0, 0.0)):
    """The simulator configuration of the JAX writer's flags."""
    cfg = sim_config()
    cfg.sim.traj_duration = duration
    cfg.sim.traj_kind = traj_kind
    cfg.sim.world_offset = tuple(world_offset)
    cfg.num_pts = num_pts
    cfg.num_pts_plane = num_pts_plane
    cfg.sim.freq_cam = freq_cam
    cfg.sim.min_feature_gen_distance = room_margin
    return cfg


def write_sim_asl(out: str, cfg, textured: bool = False, blobs: bool = True, texture_cell: float = 0.22,
                  speckle_cells: tuple = (0.15,), frames: int = 0, seed: int = 7, gt: bool = True,
                  skip_start: float = 0.0, device="cuda") -> dict:
    """Build ``cfg``'s scene with ``build_sim`` and write its ASL folder;
    returns {"frames", "imu", "seconds"}."""
    dev = resolve_device(device)
    t0 = time.time()
    truth = simulator.build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame, device=dev)
    R_ItoC, p_IinC = _camera(cfg, dev)
    wh = tuple(cfg.cam_wh)

    def render(R_GtoI, p_IinG):
        if textured:
            return render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, R_GtoI, p_IinG,
                                         R_ItoC, p_IinC, cfg.cam_intrinsics, wh, texture_cell=texture_cell,
                                         speckle_cells=speckle_cells, feat_p=truth.feat_p if blobs else None)
        return render_frame(truth.feat_p, R_GtoI, p_IinG, R_ItoC, p_IinC, cfg.cam_intrinsics, wh)

    info = write_scene(out, cfg, truth, render, frames, seed, gt, skip_start)
    return {**info, "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--scene", choices=sorted(SCENES), default=None,
                    help="export a committed scene instead of building one from the flags below")
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--num-pts", type=int, default=60)
    ap.add_argument("--num-pts-plane", type=int, default=0,
                    help="environment points on the cuboid room's planes (exercises the plane frontend)")
    ap.add_argument("--freq-cam", type=float, default=20.0, help="camera rate (EuRoC runs 20 Hz)")
    ap.add_argument("--room-margin", type=float, default=1.0,
                    help="cuboid-room margin beyond the trajectory's bounding box (sim_min_feature_gen_dist)")
    ap.add_argument("--textured", action="store_true",
                    help="raycast-render the room with procedural plane textures instead of feature blobs alone")
    ap.add_argument("--blobs", action=argparse.BooleanOptionalAction, default=True,
                    help="--no-blobs drops the feature blobs over the --textured room")
    ap.add_argument("--speckle-cells", nargs="+", default=["0.15"],
                    help="speckle layers, each 'cell' or 'cell:r_lo:r_hi' (m, radii in cells)")
    ap.add_argument("--texture-cell", type=float, default=0.22, help="world-space texture cell size (m)")
    ap.add_argument("--traj-kind", default="room_scan", help="room_scan | slow_scan | corridor | tabletop")
    ap.add_argument("--world-offset", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                    help="rigid world translation of the scene")
    ap.add_argument("--skip-start", type=float, default=0.0, help="seconds of initial frames to drop")
    ap.add_argument("--frames", type=int, default=0, help="camera frames to write (0: every frame)")
    ap.add_argument("--seed", type=int, default=7, help="seed of the IMU noise draw")
    ap.add_argument("--no-gt", action="store_true", help="omit the groundtruth csv (forces static/dynamic init)")
    ap.add_argument("--device", default="cuda", help="where the scene is built and rendered ('cuda' or 'cpu')")
    args = ap.parse_args(argv)
    if args.scene:
        info = write_asl(args.out, args.scene, args.frames, args.seed, not args.no_gt, args.device)
        what = f"the committed {args.scene} scene"
    else:
        cfg = synth_config(args.duration, args.num_pts, args.num_pts_plane, args.freq_cam, args.room_margin,
                           args.traj_kind, args.world_offset)
        layers = tuple(float(sc) if ":" not in sc else tuple(float(v) for v in sc.split(":"))
                       for sc in args.speckle_cells)
        info = write_sim_asl(args.out, cfg, args.textured, args.blobs, args.texture_cell, layers, args.frames,
                             args.seed, not args.no_gt, args.skip_start, args.device)
        what = f"a {args.duration:g} s {args.traj_kind} scene"
    print(f"[synth-asl] wrote {info['frames']} frames + {info['imu']} imu samples of {what} to "
          f"{os.path.join(args.out, 'mav0')} (gt={'no' if args.no_gt else 'yes'}) in {info['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
