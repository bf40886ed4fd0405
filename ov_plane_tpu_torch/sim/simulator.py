"""Simulator scene of the port: a committed noiseless scene + Monte-Carlo noise.

The JAX package builds the scene (trajectory spline, feature map, visibility,
IMU truth) in ``ov_plane_tpu/sim/simulator.build_sim``. Its port is a later
slice; until then the noiseless truth of these scenes is committed (generated
once from ``build_sim``; the generator lives in ``tests/test_torch_scene.py``):

* ``data/sim_config1_truth.npz`` (:data:`SCENE_PATH`): the bench scene, 30 s,
  60 free points;
* ``data/sim_planes_truth.npz`` (:data:`PLANE_SCENE_PATH`): the M-PL scene,
  30 s, 40 free points + 40 on planes, with the true plane CPs;
* ``data/sim_vision_truth.npz`` (:data:`VISION_SCENE_PATH`): the vision
  bench's scene, 6 s at 20 Hz, with the room's planes (corners, normals,
  offsets) that ``frontend.synthetic.render_frame_textured`` draws;
* ``data/sim_tabletop_truth.npz`` (:data:`TABLETOP_SCENE_PATH`): the JAX
  package's plane-firing scene (``tests/test_fused_planes.py``), a 6 s
  tabletop trajectory at 20 Hz, with its planes for the renderer.

:func:`apply_noise` draws B independent noise instances on top of a scene
with a ``torch.Generator`` (Simulator.cpp:355-382 bias walks + white IMU
noise, get_next_cam :434-439 pixel noise).

Scene-wide fields have no stream dimension; the noisy fields are [B, ...].
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ov_plane_tpu_torch.utils.torchenv import resolve_device

SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_config1_truth.npz"
PLANE_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_planes_truth.npz"
VISION_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_vision_truth.npz"
TABLETOP_SCENE_PATH = Path(__file__).resolve().parents[1] / "data" / "sim_tabletop_truth.npz"


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
        **{k: f(k) for k in ("plane_cp", "plane_corners", "plane_normal", "plane_d") if k in arrays},
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
    )


def noise_params(cfg) -> NoiseParams:
    """The configuration's noise magnitudes (as ``build_sim`` uses them)."""
    return NoiseParams(
        sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
        sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
        sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu,
    )
