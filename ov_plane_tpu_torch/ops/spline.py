"""Cumulative cubic B-spline on SE(3) with forward-mode kinematics
(counterpart of ``ov_plane_tpu/ops/spline.py``).

Control poses are fixed tensors; a pose lookup gathers four control poses
and blends them with three SE(3) exponentials (the standard cumulative
form). Velocity and acceleration are one and two nested ``torch.func.jvp``
over time, as the JAX package takes them with ``jax.jvp``. Every function
takes a tensor of query times ``t`` of any shape and returns per-time
results: each output depends only on its own time, so one jvp with a
tangent of ones gives every time's derivative at once.

Conventions: control and queried rotations are R_GtoI (JPL direction),
positions p_IinG. Internally the spline blends T_ItoG = [R_GtoIᵀ, p; 0, 1].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ov_plane_tpu_torch.ops.quat import exp_so3, log_so3, quat_2_rot, skew


class SplineSE3(NamedTuple):
    """Uniform cumulative B-spline: control transforms T_ItoG at times t0 + i·dt."""

    t0: torch.Tensor        # scalar: time of control point 0
    dt: torch.Tensor        # scalar: uniform control spacing
    ctrl_R: torch.Tensor    # [N, 3, 3] R_ItoG control rotations
    ctrl_p: torch.Tensor    # [N, 3] p_IinG control positions
    omegas: torch.Tensor    # [N-1, 6] log(T_i⁻¹ T_{i+1}) (w, v)

    @property
    def start_time(self):
        """First valid query time (control points i-1..i+2 are needed)."""
        return self.t0 + self.dt

    @property
    def end_time(self):
        return self.t0 + (self.ctrl_R.shape[0] - 2) * self.dt


def _eye(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _se3_log(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """log of T = [R, p; 0, 1] -> (w, v) with v = Jl(w)⁻¹ p. [..., 3, 3], [..., 3] -> [..., 6]."""
    w = log_so3(R)
    theta = torch.linalg.vector_norm(w, dim=-1)
    W = skew(w)
    small = theta < 1e-7
    theta_s = torch.where(small, torch.ones_like(theta), theta)
    # Jl⁻¹ = I − ½W + (1/θ² − (1 + cos θ)/(2θ sin θ)) W²
    coef = torch.where(small, torch.full_like(theta, 1.0 / 12.0),
                       1.0 / theta_s**2 - (1.0 + torch.cos(theta_s)) / (2.0 * theta_s * torch.sin(theta_s)))
    Jl_inv = _eye(R) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, (Jl_inv @ p[..., None])[..., 0]], dim=-1)


def _se3_exp(wv: torch.Tensor):
    """exp of (w, v) -> (R, p) with p = Jl(w) v. [..., 6] -> ([..., 3, 3], [..., 3]).

    Safe under forward-mode derivatives at w = 0 (exactly-zero twists come
    from duplicate control poses, a hovering segment): θ² is Σw², and the
    square root is taken of a where-guarded value only, so the Taylor
    branch's tangent carries no NaN from the other branch."""
    w, v = wv[..., 0:3], wv[..., 3:6]
    R = exp_so3(w)
    theta2 = torch.sum(w * w, dim=-1)
    W = skew(w)
    small = theta2 < 1e-14
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    theta_s = torch.sqrt(theta2_s)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_s)) / theta2_s)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta_s - torch.sin(theta_s)) / (theta2_s * theta_s))
    Jl = _eye(wv) + B[..., None, None] * W + C[..., None, None] * (W @ W)
    return R, (Jl @ v[..., None])[..., 0]


def fit_spline(times: torch.Tensor, quats_GtoI: torch.Tensor, positions: torch.Tensor) -> SplineSE3:
    """A uniform spline from (possibly non-uniform) trajectory samples
    (BsplineSE3::feed_trajectory): dt is the mean spacing; the control
    points are the trajectory resampled at uniform dt (linear position,
    log-lerp orientation between the bounding samples)."""
    n = times.shape[0]
    dt = (times[-1] - times[0]) / (n - 1)
    t_ctrl = times[0] + dt * torch.arange(n, dtype=times.dtype, device=times.device)

    R_ItoG = quat_2_rot(quats_GtoI).transpose(-1, -2)
    p = positions
    idx = torch.clamp(torch.searchsorted(times, t_ctrl, right=True) - 1, 0, n - 2)
    t_a, t_b = times[idx], times[idx + 1]
    later = t_b > t_a
    lam = torch.where(later, (t_ctrl - t_a) / torch.where(later, t_b - t_a, torch.ones_like(t_a)),
                      torch.zeros_like(t_a))
    lam = torch.clamp(lam, 0.0, 1.0)
    p_ctrl = (1 - lam[:, None]) * p[idx] + lam[:, None] * p[idx + 1]
    Ra, Rb = R_ItoG[idx], R_ItoG[idx + 1]
    R_ctrl = Ra @ exp_so3(lam[:, None] * log_so3(Ra.transpose(-1, -2) @ Rb))

    Rt = R_ctrl[:-1].transpose(-1, -2)
    omegas = _se3_log(Rt @ R_ctrl[1:], (Rt @ (p_ctrl[1:] - p_ctrl[:-1])[..., None])[..., 0])
    return SplineSE3(t0=times[0], dt=dt, ctrl_R=R_ctrl, ctrl_p=p_ctrl, omegas=omegas)


def pose(spline: SplineSE3, t: torch.Tensor):
    """T_ItoG(t) -> (R_GtoI [..., 3, 3], p_IinG [..., 3]), cumulative cubic blending."""
    n = spline.ctrl_R.shape[0]
    fi = (t - spline.t0) / spline.dt
    # The segment index is clamped to [1, n−3] before the gathers, as the JAX
    # dynamic slices clamp it: every gathered index stays in range.
    i = torch.clamp(torch.floor(fi).to(torch.int64), 1, n - 3)
    u = fi - i.to(fi.dtype)

    b1 = (5.0 + 3.0 * u - 3.0 * u**2 + u**3) / 6.0
    b2 = (1.0 + 3.0 * u + 3.0 * u**2 - 2.0 * u**3) / 6.0
    b3 = (u**3) / 6.0

    R0 = spline.ctrl_R[i - 1]
    p0 = spline.ctrl_p[i - 1]
    RA, pA = _se3_exp(b1[..., None] * spline.omegas[i - 1])
    RB, pB = _se3_exp(b2[..., None] * spline.omegas[i])
    RC, pC = _se3_exp(b3[..., None] * spline.omegas[i + 1])

    def mv(R, v):
        return (R @ v[..., None])[..., 0]

    R01 = R0 @ RA
    p01 = p0 + mv(R0, pA)
    R012 = R01 @ RB
    p012 = p01 + mv(R01, pB)
    R_ItoG = R012 @ RC
    p_IinG = p012 + mv(R012, pC)
    return R_ItoG.transpose(-1, -2), p_IinG


def velocity(spline: SplineSE3, t: torch.Tensor):
    """(R_GtoI, p, w_IinI, v_IinG) by one jvp over t (BsplineSE3::get_velocity)."""
    (R_GtoI, p), (dR, dp) = jvp(lambda tt: pose(spline, tt), (t,), (torch.ones_like(t),))
    # R_ItoG = R_GtoIᵀ; Ṙ_ItoG = R_ItoG ⌊w_body⌋ → ⌊w⌋ = R_GtoI Ṙ_ItoG.
    Wb = R_GtoI @ dR.transpose(-1, -2)
    w_IinI = torch.stack([Wb[..., 2, 1], Wb[..., 0, 2], Wb[..., 1, 0]], dim=-1)
    return R_GtoI, p, w_IinI, dp


def acceleration(spline: SplineSE3, t: torch.Tensor):
    """(R_GtoI, p, w_IinI, v, alpha_IinI, a_IinG) by nested jvps
    (BsplineSE3::get_acceleration)."""
    (R_GtoI, p, w, v), (_, _, dw, dv) = jvp(lambda tt: velocity(spline, tt), (t,), (torch.ones_like(t),))
    return R_GtoI, p, w, v, dw, dv
