"""Vectorized visual-inertial simulator (counterpart of ``ov_plane_tpu/sim/simulator.py``).

:func:`build_sim` builds a whole noiseless scene at once: the trajectory's
SE(3) spline (``ops/spline``), the cuboid room of planes around it, the
feature map (host numpy, the same seeded rejection sampling as the JAX
package, consuming its generator in the same order), then the IMU stream
(nested forward-mode derivatives of the spline) and the camera stream (the
whole map projected per frame, 10 px occupancy dedup keeping the lowest
feature index, the first ``num_pts + num_pts_plane`` valid features in map
order) as tensors on the device. :func:`apply_noise` draws B independent
Monte-Carlo instances on top of it with a ``torch.Generator``
(Simulator.cpp:355-382 bias walks + white IMU noise, get_next_cam :434-439
pixel noise); the JAX package draws with ``jax.random``, so the two noise
streams differ while their distributions agree.

Five noiseless scenes generated by the JAX ``build_sim`` are committed
(their generator lives in ``tests/test_torch_scene.py``; the port's
``build_sim`` reproduces each):

* ``data/sim_config1_truth.npz`` (:data:`SCENE_PATH`): the bench scene, 30 s,
  60 free points;
* ``data/sim_planes_truth.npz`` (:data:`PLANE_SCENE_PATH`): the M-PL scene,
  30 s, 40 free points + 40 on planes, with the true plane CPs;
* ``data/sim_vision_truth.npz`` (:data:`VISION_SCENE_PATH`): the vision
  bench's scene, 6 s at 20 Hz, with the room's planes (corners, normals,
  offsets) that ``frontend.synthetic.render_frame_textured`` draws;
* ``data/sim_tabletop_truth.npz`` (:data:`TABLETOP_SCENE_PATH`): the JAX
  package's plane-firing scene (``tests/test_fused_planes.py``), a 6 s
  tabletop trajectory at 20 Hz, with its planes for the renderer;
* ``data/sim_tabletop_replay_truth.npz`` (:data:`TABLETOP_REPLAY_SCENE_PATH`):
  the same trajectory and planes over 10 s (127 frames), the scene of the
  dataset replay (``scripts/make_synth_asl``).

Scene-wide fields have no stream dimension; the noisy fields are [B, ...].
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops import spline as sp
from ov_plane_tpu_torch.ops.quat import exp_so3, quat_2_rot, rot_2_quat
from ov_plane_tpu_torch.sim.trajectory import get_trajectory
from ov_plane_tpu_torch.utils.torchenv import resolve_device

SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_config1_truth.npz"
PLANE_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_planes_truth.npz"
VISION_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_vision_truth.npz"
TABLETOP_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_tabletop_truth.npz"
TABLETOP_REPLAY_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_tabletop_replay_truth.npz"


class SimTruth(NamedTuple):
    """Noiseless scene (the truth half of the JAX ``SimData``)."""

    imu_t: torch.Tensor        # [Ti]
    imu_w_true: torch.Tensor   # [Ti, 3]
    imu_a_true: torch.Tensor   # [Ti, 3]
    cam_t: torch.Tensor        # [Tc] camera clock
    cam_t_imu: torch.Tensor    # [Tc] IMU clock of each exposure
    obs_id: torch.Tensor       # [Tc, O] int32, -1 = pad
    obs_uv_true: torch.Tensor  # [Tc, O, 2]
    obs_plane: torch.Tensor    # [Tc, O] int32
    imu_window_start: np.ndarray  # [Tc] int: first IMU index of each frame's window (host)
    gt_q: torch.Tensor         # [Tc, 4] JPL q_GtoI
    gt_p: torch.Tensor         # [Tc, 3]
    gt_v: torch.Tensor         # [Tc, 3]
    plane_cp: torch.Tensor | None = None  # [P, 3] true plane CPs (plane scenes)
    plane_corners: torch.Tensor | None = None  # [P, 4, 3] room planes (vision scene): tl, tr, bl, br
    plane_normal: torch.Tensor | None = None   # [P, 3] unit normals, n·x = d
    plane_d: torch.Tensor | None = None        # [P]
    # The map and each observation's truth (``build_sim`` scenes), for
    # ground-truth injection.
    obs_gt_p: torch.Tensor | None = None       # [Tc, O, 3] true feature positions (zeros on pads)
    obs_gt_cp: torch.Tensor | None = None      # [Tc, O, 3] true plane CPs (zeros for free points)
    feat_p: torch.Tensor | None = None         # [N, 3] the map
    feat_plane: torch.Tensor | None = None     # [N] int32 plane of each map point (-1 free)


class SimData(NamedTuple):
    """B noisy instances of one scene."""

    imu_t: torch.Tensor        # [Ti]
    imu_w: torch.Tensor        # [B, Ti, 3]
    imu_a: torch.Tensor        # [B, Ti, 3]
    gt_bg: torch.Tensor        # [B, Ti, 3]
    gt_ba: torch.Tensor        # [B, Ti, 3]
    cam_t: torch.Tensor        # [Tc]
    cam_t_imu: torch.Tensor    # [Tc]
    obs_id: torch.Tensor       # [Tc, O]
    obs_uv: torch.Tensor       # [B, Tc, O, 2]
    obs_plane: torch.Tensor    # [Tc, O]
    imu_window_start: np.ndarray
    gt_q: torch.Tensor
    gt_p: torch.Tensor
    gt_v: torch.Tensor
    gt_bg_cam: torch.Tensor    # [B, Tc, 3]
    gt_ba_cam: torch.Tensor    # [B, Tc, 3]
    # Each observation's truth, for ground-truth injection (``build_sim`` scenes).
    obs_gt_p: torch.Tensor | None = None   # [Tc, O, 3]
    obs_gt_cp: torch.Tensor | None = None  # [Tc, O, 3]


class NoiseParams(NamedTuple):
    sigma_w: float
    sigma_a: float
    sigma_wb: float
    sigma_ab: float
    sigma_pix: float
    dt_imu: float


def truth_from_arrays(arrays, dtype=torch.float64, device="cuda") -> SimTruth:
    """SimTruth from a mapping of numpy arrays (the .npz keys / JAX field names)."""
    device = resolve_device(device)

    def f(k):
        return torch.as_tensor(np.array(arrays[k]), dtype=dtype, device=device)

    def i(k):
        return torch.as_tensor(np.array(arrays[k]), dtype=torch.int32, device=device)

    return SimTruth(
        imu_t=f("imu_t"), imu_w_true=f("imu_w_true"), imu_a_true=f("imu_a_true"),
        cam_t=f("cam_t"), cam_t_imu=f("cam_t_imu"),
        obs_id=i("obs_id"), obs_uv_true=f("obs_uv_true"), obs_plane=i("obs_plane"),
        imu_window_start=np.asarray(arrays["imu_window_start"]).astype(np.int64),
        gt_q=f("gt_q"), gt_p=f("gt_p"), gt_v=f("gt_v"),
        **{k: f(k) for k in ("plane_cp", "plane_corners", "plane_normal", "plane_d", "obs_gt_p", "obs_gt_cp",
                             "feat_p") if k in arrays},
        **({"feat_plane": i("feat_plane")} if "feat_plane" in arrays else {}),
    )


def load_scene(path=SCENE_PATH, dtype=torch.float64, device="cuda") -> SimTruth:
    """Load a committed noiseless scene (:data:`SCENE_PATH`,
    :data:`PLANE_SCENE_PATH` or :data:`VISION_SCENE_PATH`) onto ``device``."""
    with np.load(path) as z:
        return truth_from_arrays(z, dtype, device)


def _interp(ts: torch.Tensor, vals: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of vals [B, N, 3] sampled at ts [N] to times t [T]."""
    i = torch.clamp(torch.searchsorted(ts, t) - 1, 0, ts.shape[0] - 2)
    lam = torch.clamp((t - ts[i]) / (ts[i + 1] - ts[i]), 0.0, 1.0)[None, :, None]
    return (1 - lam) * vals[:, i] + lam * vals[:, i + 1]


def apply_noise(truth: SimTruth, noise: NoiseParams, batch: int, generator: torch.Generator) -> SimData:
    """Draw ``batch`` Monte-Carlo instances: bias random walks, white IMU noise
    and pixel noise on valid observations. ``generator`` lies on the scene's
    device; every instance gets its own draws."""
    dtype, dev = truth.imu_w_true.dtype, truth.imu_w_true.device
    B, n_i = batch, truth.imu_t.shape[0]
    sqdt = math.sqrt(noise.dt_imu)

    def randn(*shape):
        return torch.randn(*shape, generator=generator, dtype=dtype, device=dev)

    steps_g = noise.sigma_wb * sqdt * randn(B, n_i, 3)
    steps_a = noise.sigma_ab * sqdt * randn(B, n_i, 3)
    steps_g[:, 0] = 0.0
    steps_a[:, 0] = 0.0
    gt_bg = torch.cumsum(steps_g, dim=1)
    gt_ba = torch.cumsum(steps_a, dim=1)
    imu_w = truth.imu_w_true + gt_bg + noise.sigma_w / sqdt * randn(B, n_i, 3)
    imu_a = truth.imu_a_true + gt_ba + noise.sigma_a / sqdt * randn(B, n_i, 3)
    valid = (truth.obs_id >= 0)[..., None].to(dtype)
    obs_uv = truth.obs_uv_true + noise.sigma_pix * randn(B, *truth.obs_uv_true.shape) * valid
    return SimData(
        imu_t=truth.imu_t, imu_w=imu_w, imu_a=imu_a, gt_bg=gt_bg, gt_ba=gt_ba,
        cam_t=truth.cam_t, cam_t_imu=truth.cam_t_imu, obs_id=truth.obs_id, obs_uv=obs_uv,
        obs_plane=truth.obs_plane, imu_window_start=truth.imu_window_start,
        gt_q=truth.gt_q, gt_p=truth.gt_p, gt_v=truth.gt_v,
        gt_bg_cam=_interp(truth.imu_t, gt_bg, truth.cam_t_imu),
        gt_ba_cam=_interp(truth.imu_t, gt_ba, truth.cam_t_imu),
        obs_gt_p=truth.obs_gt_p, obs_gt_cp=truth.obs_gt_cp,
    )


def noise_params(cfg) -> NoiseParams:
    """The configuration's noise magnitudes (as ``build_sim`` uses them)."""
    return NoiseParams(
        sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
        sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
        sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu,
    )


# --------------------------------------------------------------------------- scene construction


class SimPlanes(NamedTuple):
    corners: np.ndarray  # [P, 4, 3]: top_left, top_right, bottom_left, bottom_right
    normal: np.ndarray   # [P, 3] unit
    d: np.ndarray        # [P] plane offset: n·x = d
    cp: np.ndarray       # [P, 3] closest point


def _np_rot(q) -> np.ndarray:
    return quat_2_rot(torch.as_tensor(np.asarray(q, np.float64))).numpy()


def perturb_calibration(cfg, seed: int):
    """The calibration the estimator starts from, perturbed (the simulator
    keeps the truth): Simulator::perturb_parameters (Simulator.cpp:243-275).
    Returns (calib_dt, cam_intrinsics [8], cam_extrinsics [7])."""
    rng = np.random.default_rng(seed)
    dt = cfg.calib_camimu_dt + 0.01 * rng.standard_normal()
    zeta = np.asarray(cfg.cam_intrinsics, float).copy()
    zeta[0:4] += 1.0 * rng.standard_normal(4)
    zeta[4:8] += 0.005 * rng.standard_normal(4)
    ext = np.asarray(cfg.cam_extrinsics, float).copy()
    w = 0.001 * rng.standard_normal(3)
    R_new = exp_so3(torch.as_tensor(w)).numpy() @ _np_rot(ext[0:4])
    ext[0:4] = rot_2_quat(torch.as_tensor(R_new)).numpy()
    ext[4:7] += 0.01 * rng.standard_normal(3)
    return dt, zeta, ext


def generate_planes(traj_pos: np.ndarray, min_gen_dist: float) -> SimPlanes:
    """Cuboid room around the trajectory (Simulator::generate_planes :645-707)."""
    mn = traj_pos.min(axis=0)
    mx = traj_pos.max(axis=0)
    multi_xy, multi_z = 0.7, 0.24
    mn[:2] -= multi_xy * min_gen_dist
    mn[2] -= multi_z * min_gen_dist
    mx[:2] += multi_xy * min_gen_dist
    mx[2] += multi_z * min_gen_dist
    d = mx - mn
    b1 = np.array([mn[0], mn[1], mn[2]])
    b2 = b1 + [d[0], 0, 0]
    b3 = b1 + [0, d[1], 0]
    b4 = b1 + [d[0], d[1], 0]
    t1, t2, t3, t4 = (b + [0, 0, d[2]] for b in (b1, b2, b3, b4))
    # (top_left, top_right, bottom_left, bottom_right) per face, reference order.
    faces = [
        (b1, b2, b3, b4),  # floor
        (t3, t4, t2, t1),  # ceiling
        (t3, t1, b3, b1),
        (t1, t2, b1, b2),
        (t2, t4, b2, b4),
        (t4, t3, b4, b3),
    ]
    corners = np.stack([np.stack(f) for f in faces])  # [6, 4, 3]
    v1 = corners[:, 1] - corners[:, 0]
    v2 = corners[:, 2] - corners[:, 0]
    n_raw = np.cross(v1, v2)
    normal = n_raw / np.linalg.norm(n_raw, axis=1, keepdims=True)
    d_off = np.einsum("pi,pi->p", normal, corners[:, 0])  # n·x = d
    return SimPlanes(corners=corners, normal=normal, d=d_off, cp=normal * d_off[:, None])


def _ray_plane_hits(planes: SimPlanes, origin: np.ndarray, bearing: np.ndarray):
    """First bounded-plane hit along a ray (SimPlane::calculate_intersection
    :79-102): (depth, plane index), depth inf and index -1 without a hit."""
    denom = planes.normal @ bearing
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = (planes.d - planes.normal @ origin) / denom
    pt = origin[None, :] + t[:, None] * bearing[None, :]

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    tl, tr, bl, br = (planes.corners[:, i] for i in range(4))
    V1, V2 = unit(tr - tl), unit(bl - tl)
    V3, V4 = unit(tr - br), unit(bl - br)
    U1, U2 = unit(pt - tl), unit(pt - br)
    ok = (
        (t > 0)
        & (np.einsum("pi,pi->p", U1, V1) > 0)
        & (np.einsum("pi,pi->p", U1, V2) > 0)
        & (np.einsum("pi,pi->p", U2, V3) > 0)
        & (np.einsum("pi,pi->p", U2, V4) > 0)
    )
    t = np.where(ok, t, np.inf)
    idx = int(np.argmin(t))
    return float(t[idx]), (idx if np.isfinite(t[idx]) else -1)


def _np_distort(uvn: np.ndarray, zeta: np.ndarray, model: int) -> np.ndarray:
    """Host numpy twin of ``ops/cams.distort_norm`` for the map builder."""
    x, y = uvn[..., 0], uvn[..., 1]
    fx, fy, cx, cy = zeta[0], zeta[1], zeta[2], zeta[3]
    if model == cams.RADTAN:
        k1, k2, p1, p2 = zeta[4], zeta[5], zeta[6], zeta[7]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    else:
        k1, k2, k3, k4 = zeta[4], zeta[5], zeta[6], zeta[7]
        r = np.sqrt(np.maximum(x * x + y * y, 1e-16))
        theta = np.arctan(r)
        theta_d = theta * (1 + k1 * theta**2 + k2 * theta**4 + k3 * theta**6 + k4 * theta**8)
        scale = theta_d / r
        xd, yd = x * scale, y * scale
    return np.stack([fx * xd + cx, fy * yd + cy], axis=-1)


def _np_undistort(uv: np.ndarray, zeta: np.ndarray, model: int, iters: int = 25) -> np.ndarray:
    """Fixed-point undistortion (host numpy)."""
    fx, fy, cx, cy = zeta[0], zeta[1], zeta[2], zeta[3]
    target = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
    x = target.copy()
    for _ in range(iters):
        d = _np_distort(x, zeta, model)
        dn = np.stack([(d[..., 0] - cx) / fx, (d[..., 1] - cy) / fy], axis=-1)
        x = x + (target - dn)
    return x


def _undistort_point(ud: float, vd: float, zeta: np.ndarray, model: int):
    """:func:`_np_undistort` of one pixel. The radtan model is evaluated on
    Python floats: the same IEEE double operations in the same order as the
    numpy arrays (numpy contracts no multiply-add), so the same bits, at a
    fraction of the cost in the map builder's rejection loop."""
    if model != cams.RADTAN:
        return _np_undistort(np.array([ud, vd]), zeta, model)
    fx, fy, cx, cy, k1, k2, p1, p2 = (float(z) for z in zeta)
    tx, ty = (ud - cx) / fx, (vd - cy) / fy
    x, y = tx, ty
    for _ in range(25):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = x + (tx - ((fx * xd + cx) - cx) / fx), y + (ty - ((fy * yd + cy) - cy) / fy)
    return np.array([x, y])


def _model(cfg) -> int:
    return cams.RADTAN if cfg.cam_model == "radtan" else cams.EQUI


def feature_map_from_poses(cfg, R_all: np.ndarray, p_all: np.ndarray, planes: SimPlanes, seed: int):
    """The map builder's loop over sampled poses (R_GtoI [F, 3, 3], p_IinG
    [F, 3]): each pose tops up free-space and on-plane features while it
    sees too few, by occupancy-mask rejection sampling (Simulator ctor loop
    :180-237 + generate_points). Returns (feat_p [N, 3], feat_plane [N])."""
    rng = np.random.default_rng(seed)
    zeta = np.asarray(cfg.cam_intrinsics)
    w_img, h_img = cfg.cam_wh
    model = _model(cfg)
    R_ItoC = _np_rot(cfg.cam_extrinsics[0:4])
    p_IinC = np.asarray(cfg.cam_extrinsics[4:7])
    sub = 10.0
    gw, gh = int(w_img // sub) + 1, int(h_img // sub) + 1
    max_gen, min_gen = cfg.sim.max_feature_gen_distance, cfg.sim.min_feature_gen_distance

    feat_p: list[np.ndarray] = []
    feat_plane: list[int] = []

    def project_all(R_GtoI, p_IinG):
        """The current map projected: (u, v, valid)."""
        if not feat_p:
            return np.zeros((0,)), np.zeros((0,)), np.zeros((0,), bool)
        P = np.stack(feat_p)
        p_FinC = (R_ItoC @ (R_GtoI @ (P - p_IinG).T)).T + p_IinC
        z = p_FinC[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            uvn = p_FinC[:, :2] / z[:, None]
        uv = _np_distort(np.nan_to_num(uvn), zeta, model)
        valid = ((z > 0.1) & (z <= max_gen) & (uv[:, 0] >= 0) & (uv[:, 0] <= w_img)
                 & (uv[:, 1] >= 0) & (uv[:, 1] <= h_img))
        return uv[:, 0], uv[:, 1], valid

    for R_GtoI, p_IinG in zip(R_all, p_all):
        u, v, valid = project_all(R_GtoI, p_IinG)
        pl = np.asarray(feat_plane)
        n_free = int(np.sum(valid & (pl == -1))) if len(pl) else 0
        n_plane = int(np.sum(valid & (pl >= 0))) if len(pl) else 0

        mask = np.zeros((gw, gh), bool)
        if len(pl):
            iu = np.clip((u[valid] // sub).astype(int), 0, gw - 1)
            iv = np.clip((v[valid] // sub).astype(int), 0, gh - 1)
            mask[iu, iv] = True

        cam_origin = p_IinG - R_GtoI.T @ R_ItoC.T @ p_IinC
        existing = np.stack(feat_p) if feat_p else np.zeros((0, 3))

        for want, on_plane in ((cfg.num_pts - n_free, False), (cfg.num_pts_plane - n_plane, True)):
            added = 0
            attempts = 0
            while added < want and attempts < 5000:
                attempts += 1
                ud = rng.uniform(0, w_img)
                vd = rng.uniform(0, h_img)
                cu, cv = int(ud // sub), int(vd // sub)
                if mask[cu, cv]:
                    continue
                uvn = _undistort_point(ud, vd, zeta, model)
                bearing_G = R_GtoI.T @ R_ItoC.T @ np.array([uvn[0], uvn[1], 1.0])
                if on_plane:
                    depth, pid = _ray_plane_hits(planes, cam_origin, bearing_G)
                    if pid < 0:
                        continue
                    plane_id = pid
                else:
                    depth = rng.uniform(min_gen, max_gen)
                    plane_id = -1
                p_FinG = cam_origin + depth * bearing_G
                p_FinC = R_ItoC @ (R_GtoI @ (p_FinG - p_IinG)) + p_IinC
                if p_FinC[2] < 0.1 or p_FinC[2] > max_gen:
                    continue
                if len(existing) and np.min(np.linalg.norm(existing - p_FinG, axis=1)) < 0.10:
                    continue
                mask[cu, cv] = True
                feat_p.append(p_FinG)
                feat_plane.append(plane_id)
                existing = np.vstack([existing, p_FinG[None]])
                added += 1

    return np.stack(feat_p), np.asarray(feat_plane, np.int32)


def build_feature_map(cfg, spl: sp.SplineSE3, planes: SimPlanes, t_start: float, t_end: float, seed: int):
    """Host-side map construction: the poses at 4 Hz over [t_start, t_end)
    through :func:`feature_map_from_poses`. Returns (feat_p [N, 3], feat_plane [N])."""
    times = np.arange(t_start, t_end, 0.25)
    R_all, p_all = sp.pose(spl, torch.as_tensor(times, dtype=spl.dt.dtype, device=spl.dt.device))
    return feature_map_from_poses(cfg, R_all.cpu().numpy(), p_all.cpu().numpy(), planes, seed)


def _find_start_time(spl: sp.SplineSE3, freq_cam: float, threshold: float) -> float:
    """Skip the stationary head of the trajectory (Simulator.cpp:95-124)."""
    t = float(spl.start_time)
    t_end = float(spl.end_time)
    ts = np.arange(t, t_end, 1.0 / freq_cam)
    pos = sp.pose(spl, torch.as_tensor(ts, dtype=spl.dt.dtype, device=spl.dt.device))[1].cpu().numpy()
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    idx = int(np.searchsorted(dist, threshold))
    return float(ts[min(idx, len(ts) - 1)])


def build_sim(cfg, max_obs: int | None = None, dtype=torch.float64, device="cuda") -> SimTruth:
    """The noiseless scene of ``cfg.sim``: map + measurement streams.

    The spline is fitted, the start time found and the feature map drawn on
    the host in float64 (the map's rejection sampling takes discrete
    decisions on the sampled poses); the IMU stream (spline in float64) and
    the camera stream (projection in ``dtype``) are computed on ``device``.
    Noise is added by :func:`apply_noise`."""
    device = resolve_device(device)
    max_obs = max_obs or cfg.tpu.max_obs_per_frame
    times, pos, quat = get_trajectory(cfg.sim)
    f64 = torch.float64
    spl_host = sp.fit_spline(torch.as_tensor(times, dtype=f64), torch.as_tensor(quat, dtype=f64),
                             torch.as_tensor(pos, dtype=f64))
    t_start = _find_start_time(spl_host, cfg.sim.freq_cam, cfg.sim.distance_threshold)
    # One control interval of margin at the end for acceleration queries.
    t_end = float(spl_host.end_time) - 2.0 * float(spl_host.dt)
    planes = generate_planes(pos, cfg.sim.min_feature_gen_distance)
    feat_p, feat_plane = build_feature_map(cfg, spl_host, planes, t_start, t_end, cfg.sim.seed_state_init)
    spl = sp.SplineSE3(*(x.to(device) for x in spl_host))

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    # IMU stream.
    dt_imu = 1.0 / cfg.sim.freq_imu
    imu_t = np.arange(t_start + dt_imu, t_end, dt_imu)
    R_GtoI_i, _, w_IinI, _, _, a_IinG = sp.acceleration(spl, dev(imu_t, f64))
    gravity = torch.tensor([0.0, 0.0, cfg.gravity_mag], dtype=f64, device=device)
    a_body = (R_GtoI_i @ (a_IinG + gravity)[..., None])[..., 0]

    # Camera stream.
    dt_cam = 1.0 / cfg.sim.freq_cam
    cam_t_imu = np.arange(t_start + dt_cam, t_end - dt_imu, dt_cam)
    R_GtoI_c, p_c, _, v_c = sp.velocity(spl, dev(cam_t_imu, f64))
    gt_q = rot_2_quat(R_GtoI_c)
    obs_id, obs_uv_true, obs_plane = _frame_obs(cfg, R_GtoI_c.to(dtype), p_c.to(dtype), dev(feat_p),
                                                dev(feat_plane, torch.int64), max_obs)

    # IMU window bookkeeping: the first IMU index at or after each previous
    # frame's time, less a margin of 9 samples (time-offset calibration).
    prev_t = np.concatenate([[t_start], cam_t_imu[:-1]])
    win_start = np.clip(np.searchsorted(imu_t, prev_t - 1e-9) - 9, 0, None).astype(np.int64)

    fp = dev(feat_p)
    cp = dev(planes.cp)
    obs_gt_p = torch.cat([fp, fp.new_zeros(1, 3)])[torch.where(obs_id >= 0, obs_id.long(), fp.shape[0])]
    obs_gt_cp = torch.cat([cp, cp.new_zeros(1, 3)])[torch.where(obs_plane >= 0, obs_plane.long(), cp.shape[0])]
    tc = dev(cam_t_imu)
    return SimTruth(
        imu_t=dev(imu_t), imu_w_true=w_IinI.to(dtype), imu_a_true=a_body.to(dtype),
        cam_t=tc - cfg.calib_camimu_dt, cam_t_imu=tc, obs_id=obs_id, obs_uv_true=obs_uv_true,
        obs_plane=obs_plane, imu_window_start=win_start, gt_q=gt_q.to(dtype), gt_p=p_c.to(dtype),
        gt_v=v_c.to(dtype), plane_cp=cp, plane_corners=dev(planes.corners), plane_normal=dev(planes.normal),
        plane_d=dev(planes.d), obs_gt_p=obs_gt_p, obs_gt_cp=obs_gt_cp, feat_p=fp,
        feat_plane=dev(feat_plane, torch.int32),
    )


def _frame_obs(cfg, R_GtoI: torch.Tensor, p_IinG: torch.Tensor, fp: torch.Tensor, fplane: torch.Tensor,
               max_obs: int):
    """Every frame's observations (project_pointcloud :450-507): the whole
    map projected, a 10 px occupancy dedup that keeps the lowest feature
    index per cell, and the first ``num_pts + num_pts_plane`` valid features
    in map order. Returns (obs_id [Tc, O] int32, obs_uv [Tc, O, 2], obs_plane
    [Tc, O] int32), -1 and zeros on pads."""
    dtype, device = fp.dtype, fp.device
    Tc, N = R_GtoI.shape[0], fp.shape[0]
    zeta = torch.as_tensor(cfg.cam_intrinsics, dtype=dtype, device=device)
    R_ItoC = quat_2_rot(torch.as_tensor(cfg.cam_extrinsics[0:4], dtype=dtype, device=device))
    p_IinC = torch.as_tensor(cfg.cam_extrinsics[4:7], dtype=dtype, device=device)
    w_img, h_img = cfg.cam_wh
    n_select = cfg.num_pts + cfg.num_pts_plane

    p_FinC = ((fp[None] - p_IinG[:, None]) @ R_GtoI.transpose(-1, -2)) @ R_ItoC.T + p_IinC
    z = p_FinC[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    uv = cams.distort_norm(p_FinC[..., :2] / z_safe[..., None], zeta, _model(cfg))
    valid = ((z > 0.1) & (z <= cfg.sim.max_feature_gen_distance) & (uv[..., 0] >= 0) & (uv[..., 0] <= w_img)
             & (uv[..., 1] >= 0) & (uv[..., 1] <= h_img))
    # Occupancy dedup at 10 px: one stable sort on the unique key cell·N + idx
    # (an invalid feature gets a cell of its own, −1 − idx), then a feature
    # whose cell equals its predecessor's is a duplicate.
    order = torch.arange(N, device=device)
    cellf = torch.floor(uv[..., 0] / 10.0) * (h_img // 10 + 2) + torch.floor(uv[..., 1] / 10.0)
    cell = torch.where(valid, torch.where(valid, cellf, 0.0).to(torch.int64), -1 - order)
    perm = torch.sort(cell * N + order, dim=-1, stable=True).indices
    cell_sorted = cell.gather(1, perm)
    dup_sorted = torch.cat([torch.zeros_like(cell_sorted[:, :1], dtype=torch.bool),
                            cell_sorted[:, 1:] == cell_sorted[:, :-1]], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter(1, perm, dup_sorted)
    valid = valid & ~dup
    # The first n_select valid features in map order; the rest go to the
    # overflow slot max_obs, which is cut off (every index stays in range).
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    take = valid & (rank < n_select) & (rank < max_obs)
    slot = torch.where(take, rank, max_obs)
    ids = torch.full((Tc, max_obs + 1), -1, dtype=torch.int64, device=device)
    ids.scatter_(1, slot, torch.where(take, order, -1))
    pls = torch.full((Tc, max_obs + 1), -1, dtype=torch.int64, device=device)
    pls.scatter_(1, slot, torch.where(take, fplane[None].expand(Tc, N), -1))
    uvs = torch.zeros((Tc, max_obs + 1, 2), dtype=dtype, device=device)
    uvs.scatter_(1, slot[..., None].expand(Tc, N, 2), torch.where(take[..., None], uv, 0.0))
    return ids[:, :max_obs].to(torch.int32), uvs[:, :max_obs], pls[:, :max_obs].to(torch.int32)
