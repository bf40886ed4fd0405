"""Trajectory sources of the simulator (counterpart of ``ov_plane_tpu/sim/trajectory.py``).

* :func:`load_trajectory_txt` reads the reference's simulated-trajectory
  format ``# timestamp(s) tx ty tz qx qy qz qw``;
* :func:`room_scan_trajectory`, :func:`corridor_trajectory` and
  :func:`tabletop_trajectory` generate the procedural paths.

Everything is host numpy in float64, as in the JAX package; the rotation to
JPL quaternion conversion is the port's ``ops/quat.rot_2_quat``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ov_plane_tpu_torch.ops.quat import rot_2_quat


def load_trajectory_txt(path: str):
    """(times [N], pos [N, 3], quat_GtoI [N, 4] JPL xyzw). Times are rebased to
    0 (a recorded epoch leaves no sub-second resolution in float32); z is
    mean-centred like the reference simulator (Simulator.cpp:68-75)."""
    data = np.loadtxt(path, comments="#")
    times = data[:, 0] - data[0, 0]
    pos = data[:, 1:4].copy()
    quat = data[:, 4:8].copy()
    pos[:, 2] -= pos[:, 2].mean()
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return times, pos, quat


def _quats(yaw, pitch, roll) -> np.ndarray:
    """JPL q_GtoI [n, 4] of R_GtoI = (R_z(yaw) R_y(pitch) R_x(roll))ᵀ."""
    n = yaw.shape[0]
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    R_ItoG = np.zeros((n, 3, 3))
    R_ItoG[:, 0, 0] = cz * cy
    R_ItoG[:, 0, 1] = cz * sy * sx - sz * cx
    R_ItoG[:, 0, 2] = cz * sy * cx + sz * sx
    R_ItoG[:, 1, 0] = sz * cy
    R_ItoG[:, 1, 1] = sz * sy * sx + cz * cx
    R_ItoG[:, 1, 2] = sz * sy * cx - cz * sx
    R_ItoG[:, 2, 0] = -sy
    R_ItoG[:, 2, 1] = cy * sx
    R_ItoG[:, 2, 2] = cy * cx
    R_GtoI = R_ItoG.transpose(0, 2, 1)
    return rot_2_quat(torch.from_numpy(np.ascontiguousarray(R_GtoI))).numpy()


def room_scan_trajectory(duration: float = 60.0, hz: float = 100.0, seed: int = 0,
                         time_dilation: float = 1.0):
    """Smooth figure-eight room scan with height oscillation, facing along
    the direction of travel with a gentle pitch/roll sway (every IMU axis
    excited). ``time_dilation`` > 1 replays the same path at 1/dilation the
    speed (the slow close-range inspection regime). Returns (times, pos,
    quat_GtoI) as :func:`load_trajectory_txt` does."""
    if time_dilation != 1.0:
        times, pos, quat = room_scan_trajectory(duration / time_dilation, hz * time_dilation, seed)
        return times * time_dilation, pos, quat
    n = int(duration * hz) + 1
    t = np.arange(n) / hz
    # Lissajous-style loop inside a ~6x4 m room.
    wx, wy = 2 * np.pi / 17.0, 2 * np.pi / 9.5
    px = 2.5 * np.sin(wx * t) + 0.5 * np.sin(3.1 * wy * t) * 0.2
    py = 1.6 * np.sin(wy * t + 0.7)
    pz = 0.35 * np.sin(2 * np.pi * t / 7.3) + 0.1 * np.sin(2 * np.pi * t / 2.9)
    pos = np.stack([px, py, pz], axis=1)
    vx = np.gradient(px, t)
    vy = np.gradient(py, t)
    yaw = np.unwrap(np.arctan2(vy, vx))
    pitch = 0.12 * np.sin(2 * np.pi * t / 5.1)
    roll = 0.10 * np.sin(2 * np.pi * t / 3.7 + 1.0)
    quat = _quats(yaw, pitch, roll)
    pos[:, 2] -= pos[:, 2].mean()
    return t, pos, quat


def corridor_trajectory(duration: float = 30.0, hz: float = 100.0):
    """Corridor walk: a slow advance down a long hallway with a look-around
    sweeping 26°-80° off the corridor axis (the side walls seen near
    frontally), so ``generate_planes`` builds a long narrow room."""
    n = int(duration * hz) + 1
    t = np.arange(n) / hz
    advance = 0.25 * duration                       # ~0.25 m/s walking pace
    px = advance * (t / duration) + 0.15 * np.sin(2 * np.pi * t / 6.3)
    py = 0.25 * np.sin(2 * np.pi * t / 8.7)
    pz = 0.08 * np.sin(2 * np.pi * t / 4.1)
    pos = np.stack([px, py, pz], axis=1)
    yaw = 0.93 + 0.47 * np.sin(2 * np.pi * t / 9.0)
    pitch = 0.10 * np.sin(2 * np.pi * t / 5.3)
    roll = 0.08 * np.sin(2 * np.pi * t / 3.9 + 0.8)
    quat = _quats(yaw, pitch, roll)
    pos[:, 2] -= pos[:, 2].mean()
    return t, pos, quat


def tabletop_trajectory(duration: float = 25.0, hz: float = 100.0):
    """Table-top inspection orbit (the reference's AR-Table regime): ~0.55 m
    from the scene centre at ~0.5 m height, pitched ~50° down. z is not
    mean-centred: the table stays ~0.5 m below the origin-centred orbit."""
    n = int(duration * hz) + 1
    t = np.arange(n) / hz
    w_orb = 2 * np.pi / 11.0                        # one lap ≈ 11 s
    th = w_orb * t
    r = 0.55 + 0.05 * np.sin(2 * np.pi * t / 7.9)
    px = r * np.cos(th)
    py = r * np.sin(th)
    pz = 0.52 + 0.05 * np.sin(2 * np.pi * t / 5.7)
    pos = np.stack([px, py, pz], axis=1)
    yaw = np.unwrap(th + np.pi)
    pitch = 0.88 + 0.10 * np.sin(2 * np.pi * t / 6.1)
    roll = 0.08 * np.sin(2 * np.pi * t / 4.3 + 0.6)
    return t, pos, _quats(yaw, pitch, roll)


def get_trajectory(cfg_sim):
    """The configured trajectory: the txt file ``traj_path`` when it exists
    (``traj_start`` seconds skipped, then cut to ``traj_duration`` seconds
    when positive; each cut only if 8 samples remain), else the procedural
    ``traj_kind`` of ``traj_duration`` seconds moved by ``world_offset``."""
    if cfg_sim.traj_path and os.path.exists(cfg_sim.traj_path):
        times, pos, quat = load_trajectory_txt(cfg_sim.traj_path)
        start = float(cfg_sim.traj_start or 0.0)
        if start > 0:
            keep = times >= times[0] + start
            if keep.sum() >= 8:
                times, pos, quat = times[keep], pos[keep], quat[keep]
        if cfg_sim.traj_duration and cfg_sim.traj_duration > 0:
            keep = times <= times[0] + cfg_sim.traj_duration
            if keep.sum() >= 8:
                times, pos, quat = times[keep], pos[keep], quat[keep]
        return times, pos, quat
    off = np.asarray(cfg_sim.world_offset, float)
    if cfg_sim.traj_kind == "slow_scan":
        t, p, q = room_scan_trajectory(duration=cfg_sim.traj_duration, time_dilation=3.0)
    elif cfg_sim.traj_kind == "corridor":
        t, p, q = corridor_trajectory(duration=cfg_sim.traj_duration)
    elif cfg_sim.traj_kind == "tabletop":
        t, p, q = tabletop_trajectory(duration=cfg_sim.traj_duration)
    else:
        t, p, q = room_scan_trajectory(duration=cfg_sim.traj_duration)
    return t, p + off[None, :], q
