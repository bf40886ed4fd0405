"""The benchmark's inputs, made from the seed by the benchmark itself, never
by the program: the noisy Monte-Carlo instances of a committed noiseless
scene (``data/*.npz``), in float64 on the device from one
``torch.Generator``:

* each stream's gyroscope and accelerometer bias as a random walk
  (σ_wb·√dt, σ_ab·√dt per IMU sample), and white IMU noise (σ_w/√dt,
  σ_a/√dt) on the true rates and forces plus the bias;
* white pixel noise (σ_pix) on every valid observation.

Every seed gives the same sizes, times and tracks; only the noise differs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from common import HERE


def load_scene(path, device) -> dict:
    """The committed scene's arrays: floats as float64 and ids as int32
    tensors on ``device``, ``imu_window_start`` as a host array."""
    out = {}
    with np.load(HERE / path) as z:
        for k in z.files:
            a = np.asarray(z[k])
            if k == "imu_window_start":
                out[k] = a.astype(np.int64)
            elif a.dtype.kind in "iu":
                out[k] = torch.as_tensor(a, dtype=torch.int32, device=device)
            else:
                out[k] = torch.as_tensor(a, dtype=torch.float64, device=device)
    return out


def _interp(ts, vals, t):
    """vals [B, N, 3] sampled at ts [N], linearly interpolated at times t [T]."""
    i = torch.clamp(torch.searchsorted(ts, t) - 1, 0, ts.shape[0] - 2)
    lam = torch.clamp((t - ts[i]) / (ts[i + 1] - ts[i]), 0.0, 1.0)[None, :, None]
    return (1 - lam) * vals[:, i] + lam * vals[:, i + 1]


def noisy_scene(config: dict, batch: int, seed: int, device) -> dict:
    """``batch`` noisy instances of the config's scene: the scene's arrays
    with ``imu_w``, ``imu_a`` [B, Ti, 3], ``obs_uv`` [B, Tc, O, 2] and each
    stream's true biases at the camera times ``gt_bg_cam``, ``gt_ba_cam``
    [B, Tc, 3], all float64 on ``device``."""
    sc = load_scene(config["scene"], device)
    n = config["imu_noise"]
    gen = torch.Generator(device=device).manual_seed(seed)
    B, Ti = batch, sc["imu_t"].shape[0]
    sqdt = math.sqrt(1.0 / config["imu_rate_hz"])

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, device=device)

    steps_g = n["sigma_wb"] * sqdt * randn(B, Ti, 3)
    steps_a = n["sigma_ab"] * sqdt * randn(B, Ti, 3)
    steps_g[:, 0] = 0.0
    steps_a[:, 0] = 0.0
    bg, ba = torch.cumsum(steps_g, dim=1), torch.cumsum(steps_a, dim=1)
    sc["imu_w"] = sc["imu_w_true"] + bg + n["sigma_w"] / sqdt * randn(B, Ti, 3)
    sc["imu_a"] = sc["imu_a_true"] + ba + n["sigma_a"] / sqdt * randn(B, Ti, 3)
    valid = (sc["obs_id"] >= 0)[..., None].to(torch.float64)
    sc["obs_uv"] = sc["obs_uv_true"] + config["pixel_sigma"] * randn(B, *sc["obs_uv_true"].shape) * valid
    sc["gt_bg_cam"] = _interp(sc["imu_t"], bg, sc["cam_t_imu"])
    sc["gt_ba_cam"] = _interp(sc["imu_t"], ba, sc["cam_t_imu"])
    return sc
