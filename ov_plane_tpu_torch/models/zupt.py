"""Zero-velocity update (ZUPT) of B streams.

Counterpart of ``ov_plane_tpu/models/zupt.py`` (UpdaterZeroVelocity::try_update,
UpdaterZeroVelocity.cpp:68-318), in its three formulations:

* standard: the pseudo-measurements ω = 0 and a = R·g over every interval of
  the frame's IMU window, whitened per interval, the bias random walk added
  to the covariance, and a χ² + velocity + image-disparity acceptance;
* ``integrated_accel``: the accelerometer rows become the velocity integral
  v − g·dt + Rᵀâ·dt = 0 (with velocity columns);
* ``explicit_zero_motion``: after the frame's propagate-and-clone, the
  relative pose between the previous clone and the new one and the velocity
  are constrained to zero (9 rows), and the new clone is marginalized.

Every stream gets its ZUPT result; which streams take it is a [B] flag the
frame step selects on. The standard update closes 6·(W−1) rows per stream
through ``ekf.kalman_update`` (the downdate kernel); masked intervals are
zero rows with unit noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models.msckf import chi2_table
from ov_plane_tpu_torch.ops import ekf
from ov_plane_tpu_torch.ops.quat import log_so3, quat_2_rot, skew
from ov_plane_tpu_torch.state.vio_state import VioState


class ZuptOptions(NamedTuple):
    chi2_multipler: float = 1.0
    noise_multiplier: float = 50.0
    max_velocity: float = 0.1
    max_disparity: float = 0.5
    only_at_beginning: bool = True
    sigma_w2: float = 1.6968e-04**2
    sigma_a2: float = 2.0e-3**2
    sigma_wb2: float = 1.9393e-05**2
    sigma_ab2: float = 3.0e-03**2
    do_fej: bool = True
    gravity_mag: float = 9.81
    integrated_accel: bool = False
    explicit_zero_motion: bool = False


def _cols(D: int, start: int, block: torch.Tensor) -> torch.Tensor:
    """[..., r, D] rows holding block [..., r, c] at the columns [start, start + c)."""
    out = torch.zeros(block.shape[:-1] + (D,), dtype=block.dtype, device=block.device)
    out[..., start:start + block.shape[-1]] = block
    return out


def try_zupt(state: VioState, opts: ZuptOptions, imu_t, imu_w, imu_a, t_new, avg_disparity, n_disp_features):
    """Attempt a zero-velocity update over [t, t_new] of every stream.

    imu_t [B, I], imu_w / imu_a [B, I, 3] (the frame's padded window), t_new,
    avg_disparity, n_disp_features [B]. Returns (zupt_state, accepted [B]):
    the state after the update with its time advanced (no clone), and
    whether each stream accepts it."""
    lay = state.layout
    D = lay.dim
    dtype, dev = state.imu.dtype, state.imu.device
    B, I = imu_t.shape
    table = chi2_table(dtype, dev)

    bg, ba = state.imu[:, 10:13], state.imu[:, 13:16]
    R_GtoI = quat_2_rot(state.imu[:, 0:4])
    R_jac = quat_2_rot(state.imu_fej[:, 0:4]) if opts.do_fej else R_GtoI
    gravity = torch.zeros(3, dtype=dtype, device=dev)      # filled on the device: no host copy in a step
    gravity[2] = opts.gravity_mag

    # Camera clock -> IMU clock (UpdaterZeroVelocity.cpp:91-100).
    t0_imu = (state.t + state.last_dt)[:, None]
    t1_imu = (t_new + state.calib_dt)[:, None]
    ta = torch.minimum(torch.maximum(imu_t[:, :-1], t0_imu), t1_imu)
    tb = torch.minimum(torch.maximum(imu_t[:, 1:], t0_imu), t1_imu)
    dt = tb - ta
    valid = (dt > 0) & torch.isfinite(dt)
    vf = valid.to(dtype)
    dt_s = torch.where(valid, dt, torch.ones_like(dt))                       # [B, I-1]

    r_w = -(imu_w[:, :-1] - bg[:, None]) * vf[..., None]
    a_hat = imu_a[:, :-1] - ba[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    if opts.integrated_accel:
        v = state.imu[:, 7:10]
        r_a = -(v[:, None] - gravity * dt_s[..., None] + (a_hat @ R_GtoI) * dt_s[..., None]) * vf[..., None]
        s_a = torch.sqrt(opts.sigma_a2 * dt_s * opts.noise_multiplier)
        RjT = R_jac.transpose(-1, -2)[:, None]                                # [B, 1, 3, 3]
        Ha = (_cols(D, lay.IMU_TH, -(RjT @ skew(a_hat)) * dt_s[..., None, None])
              + _cols(D, lay.IMU_BA, -RjT.expand(B, I - 1, 3, 3) * dt_s[..., None, None])
              + _cols(D, lay.IMU_V, eye3.expand(B, I - 1, 3, 3)))
    else:
        r_a = -(a_hat - (R_GtoI @ gravity)[:, None]) * vf[..., None]
        s_a = torch.sqrt(opts.sigma_a2 / dt_s * opts.noise_multiplier)
        Ha = (_cols(D, lay.IMU_TH, -skew(R_jac @ gravity)[:, None].expand(B, I - 1, 3, 3))
              + _cols(D, lay.IMU_BA, -eye3.expand(B, I - 1, 3, 3)))
    s_w = torch.sqrt(opts.sigma_w2 / dt_s * opts.noise_multiplier)
    Hg = _cols(D, lay.IMU_BG, -eye3.expand(B, I - 1, 3, 3)) / s_w[..., None, None] * vf[..., None, None]
    Ha = Ha / s_a[..., None, None] * vf[..., None, None]

    # Rows per interval: gyro (3) then accel (3).
    H = torch.cat([Hg, Ha], dim=2).reshape(B, (I - 1) * 6, D)
    res = torch.cat([r_w / s_w[..., None], r_a / s_a[..., None]], dim=2).reshape(B, (I - 1) * 6)
    ones = torch.ones_like(res)

    # Bias random walk over the window (UpdaterZeroVelocity.cpp:183-193).
    dt_sum = torch.where(valid, dt, torch.zeros_like(dt)).sum(dim=-1)
    q_bias = torch.zeros(B, D, dtype=dtype, device=dev)
    q_bias[:, lay.IMU_BG:lay.IMU_BG + 3] = (dt_sum * opts.sigma_wb2 ** 0.5)[:, None]
    q_bias[:, lay.IMU_BA:lay.IMU_BA + 3] = (dt_sum * opts.sigma_ab2 ** 0.5)[:, None]
    new_cov = state.cov + torch.diag_embed(q_bias)

    chi2 = ekf.innovation_chi2(new_cov, H, res, ones)
    n_rows = 6 * valid.sum(dim=-1)
    chi2_ok = chi2 <= opts.chi2_multipler * table[n_rows.clamp(1, table.shape[0] - 1)]
    vel_ok = torch.linalg.vector_norm(state.imu[:, 7:10], dim=-1) <= opts.max_velocity
    disparity_ok = (avg_disparity < opts.max_disparity) & (n_disp_features > 20)
    accepted = disparity_ok | (chi2_ok & vel_ok)

    zupt_state, _ = ekf.ekf_update(state.replace(cov=new_cov), H, res, ones)
    return zupt_state.replace(t=t_new.to(dtype), last_dt=state.calib_dt), accepted


def zupt_explicit_update(state: VioState, opts: ZuptOptions, slot0: torch.Tensor, slot1: torch.Tensor) -> VioState:
    """Explicit zero-motion formulation (UpdaterZeroVelocity.cpp:252-313),
    after the frame's propagate-and-clone into clone slot1 [B]: the relative
    orientation and position between clone slot0 [B] and slot1, and the
    velocity, are constrained to zero with the noise (1e-2, 1e-1, 1e-1);
    then the transient clone slot1 is marginalized."""
    lay = state.layout
    D, K = lay.dim, lay.max_clones
    dtype, dev = state.imu.dtype, state.imu.device
    B = slot0.shape[0]

    def at(x, slot):
        return x.gather(1, slot.reshape(B, 1, *([1] * (x.dim() - 2))).expand(B, 1, *x.shape[2:]))[:, 0]

    R0 = quat_2_rot(at(state.clones_q, slot0))
    R1 = quat_2_rot(at(state.clones_q, slot1))
    p0, p1 = at(state.clones_p, slot0), at(state.clones_p, slot1)
    R0_jac = quat_2_rot(at(state.clones_q_fej, slot0)) if opts.do_fej else R0

    # Residuals, sign-flipped as in the reference (res *= -1, :285).
    res = torch.cat([log_so3(R0 @ R1.transpose(-1, -2)), -(p1 - p0), -state.imu[:, 7:10]], dim=1)
    sig = torch.full((9,), 1e-1, dtype=dtype, device=dev)
    sig[:3] = 1e-2

    # Blocks written in the JAX order, a later block over an earlier one.
    j = torch.arange(D, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    c0 = lay.clone_base + 6 * slot0
    c1 = lay.clone_base + 6 * slot1
    H = torch.zeros(B, 9, D, dtype=dtype, device=dev)

    def put(H, r0, col, blk):
        """H with blk [B, 3, 3] at rows [r0, r0 + 3) and the columns [col, col + 3)."""
        inside = (j[None, :] >= col[:, None]) & (j[None, :] < col[:, None] + 3)        # [B, D]
        spread = blk.gather(2, (j[None, :] - col[:, None]).clamp(0, 2)[:, None, :].expand(B, 3, D))
        H = H.clone()
        H[:, r0:r0 + 3] = torch.where(inside[:, None, :], spread, H[:, r0:r0 + 3])
        return H

    H = put(H, 0, c0, eye3)                 # ∂/∂θ0 = I
    H = put(H, 0, c1, -R0_jac)              # ∂/∂θ1 = −R0_jac
    H = put(H, 3, c0 + 3, -eye3)            # ∂/∂p0 = −I
    H = put(H, 3, c1 + 3, eye3)             # ∂/∂p1 = I
    H[:, 6:9, lay.IMU_V:lay.IMU_V + 3] = eye3
    H = H / sig[:, None]
    res = res / sig

    new_state, _ = ekf.ekf_update(state, H, res, torch.ones_like(res))
    # Remove the transient clone (StateHelper::marginalize + erase, :311-312).
    oh = torch.nn.functional.one_hot(slot1, K).bool()
    return new_state.replace(
        cov=ekf.zero_slot(new_state.cov, c1, 6),
        clones_t=torch.where(oh, torch.full_like(new_state.clones_t, -torch.inf), new_state.clones_t))


def compute_disparity(bank_uv, bank_mask, prev_slot, cur_slot):
    """Average pixel disparity between two clone slots [B] over the tracks seen
    in both (bank_uv [B, F, K, 2], bank_mask [B, F, K]). Returns (avg [B], n [B])."""
    def col(x, slot):
        idx = slot.reshape(-1, 1, 1, *([1] * (x.dim() - 3))).expand(x.shape[0], x.shape[1], 1, *x.shape[3:])
        return x.gather(2, idx)[:, :, 0]

    both = col(bank_mask, prev_slot) & col(bank_mask, cur_slot)
    d = torch.linalg.vector_norm(col(bank_uv, cur_slot) - col(bank_uv, prev_slot), dim=-1)
    n = both.sum(dim=-1)
    avg = torch.where(both, d, torch.zeros_like(d)).sum(dim=-1) / torch.clamp(n, min=1)
    return avg, n
