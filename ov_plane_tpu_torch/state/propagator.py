"""IMU mean + covariance propagation and stochastic cloning, for B streams.

Counterpart of ``ov_plane_tpu/state/propagator.py``. The masked scan over a
fixed-size IMU window becomes a Python loop over its sample pairs: each pair
is clipped to the propagation interval [t0, t1] with linear interpolation of
the boundary samples, and a clipped interval of zero length (padding, +inf
times) leaves the state untouched. RK4 / discrete means and the FEJ or
standard analytic Φ and G blocks follow Propagator.cpp:343-569.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops import ekf
from ov_plane_tpu_torch.ops.quat import exp_so3, jr_so3, omega, quat_2_rot, quat_multiply, quat_norm, skew
from ov_plane_tpu_torch.state.vio_state import VioState


class PropagatorOptions(NamedTuple):
    use_rk4: bool = True
    imu_avg: bool = True
    do_fej: bool = True


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def predict_mean_rk4(imu, dt, w1, a1, w2, a2, gravity):
    """RK4 integration of (q, p, v) over one interval; dt [B], vectors [B, 3]."""
    q_0, p_0, v_0 = imu[:, 0:4], imu[:, 4:7], imu[:, 7:10]
    dtc = dt[:, None]
    w_alpha = (w2 - w1) / dtc
    a_jerk = (a2 - a1) / dtc

    def qdot(dq, w):
        return 0.5 * _mv(omega(w), dq)

    def vdot(dq, a):
        return _mv(quat_2_rot(quat_multiply(dq, q_0)).transpose(-1, -2), a) - gravity

    dq_0 = torch.zeros_like(q_0)
    dq_0[:, 3] = 1.0
    w_hat, a_hat = w1, a1
    k1_q = qdot(dq_0, w_hat) * dtc
    k1_p = v_0 * dtc
    k1_v = vdot(dq_0, a_hat) * dtc
    w_hat = w1 + 0.5 * w_alpha * dtc
    a_hat = a1 + 0.5 * a_jerk * dtc
    dq_1 = quat_norm(dq_0 + 0.5 * k1_q)
    v_1 = v_0 + 0.5 * k1_v
    k2_q = qdot(dq_1, w_hat) * dtc
    k2_p = v_1 * dtc
    k2_v = vdot(dq_1, a_hat) * dtc
    dq_2 = quat_norm(dq_0 + 0.5 * k2_q)
    v_2 = v_0 + 0.5 * k2_v
    k3_q = qdot(dq_2, w_hat) * dtc
    k3_p = v_2 * dtc
    k3_v = vdot(dq_2, a_hat) * dtc
    w_hat = w1 + w_alpha * dtc
    a_hat = a1 + a_jerk * dtc
    dq_3 = quat_norm(dq_0 + k3_q)
    v_3 = v_0 + k3_v
    k4_q = qdot(dq_3, w_hat) * dtc
    k4_p = v_3 * dtc
    k4_v = vdot(dq_3, a_hat) * dtc

    dq = quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    new_q = quat_multiply(dq, q_0)
    new_p = p_0 + (k1_p + 2 * k2_p + 2 * k3_p + k4_p) / 6.0
    new_v = v_0 + (k1_v + 2 * k2_v + 2 * k3_v + k4_v) / 6.0
    return new_q, new_p, new_v


def predict_mean_discrete(imu, dt, w1, a1, w2, a2, gravity, imu_avg: bool):
    """Constant-measurement discrete integration (Propagator.cpp:456-488)."""
    q_0, p_0, v_0 = imu[:, 0:4], imu[:, 4:7], imu[:, 7:10]
    w_hat = 0.5 * (w1 + w2) if imu_avg else w1
    a_hat = 0.5 * (a1 + a2) if imu_avg else a1
    w_norm = torch.linalg.vector_norm(w_hat, dim=-1)
    I4 = torch.eye(4, dtype=imu.dtype, device=imu.device)
    big = (w_norm > 1e-20)[:, None, None]
    wn_s = torch.where(w_norm > 1e-20, w_norm, torch.ones_like(w_norm))
    hw = 0.5 * w_norm * dt
    big_o = torch.where(
        big,
        torch.cos(hw)[:, None, None] * I4 + (torch.sin(hw) / wn_s)[:, None, None] * omega(w_hat),
        I4 + 0.5 * dt[:, None, None] * omega(w_hat),
    )
    new_q = quat_norm(_mv(big_o, q_0))
    RT = quat_2_rot(q_0).transpose(-1, -2)
    dtc = dt[:, None]
    new_v = v_0 + _mv(RT, a_hat) * dtc - gravity * dtc
    new_p = p_0 + v_0 * dtc + 0.5 * _mv(RT, a_hat) * dtc * dtc - 0.5 * gravity * dtc * dtc
    return new_q, new_p, new_v


def _phi_g_blocks(imu, imu_fej, new_q, new_p, new_v, dt, w_hat, a_hat, gravity, do_fej: bool):
    """Analytic Φ [B, 15, 15] and noise Jacobian G [B, 15, 12] (Propagator.cpp:375-432)."""
    B, dtype, dev = imu.shape[0], imu.dtype, imu.device
    I3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.zeros(B, 15, 15, dtype=dtype, device=dev)
    G = torch.zeros(B, 15, 12, dtype=dtype, device=dev)
    dt3 = dt[:, None, None]
    dtc = dt[:, None]
    if do_fej:
        RfT = quat_2_rot(imu_fej[:, 0:4]).transpose(-1, -2)
        v_fej, p_fej = imu_fej[:, 7:10], imu_fej[:, 4:7]
        dR = quat_2_rot(new_q) @ RfT
        th_bg = -dR @ jr_so3(-w_hat * dtc) * dt3
        F[:, 0:3, 0:3] = dR
        F[:, 0:3, 9:12] = th_bg
        F[:, 6:9, 0:3] = -skew(new_v - v_fej + gravity * dtc) @ RfT
        F[:, 6:9, 12:15] = -RfT * dt3
        F[:, 3:6, 0:3] = -skew(new_p - p_fej - v_fej * dtc + 0.5 * gravity * dtc * dtc) @ RfT
        F[:, 3:6, 12:15] = -0.5 * RfT * dt3 * dt3
        G[:, 0:3, 0:3] = th_bg
        G[:, 6:9, 3:6] = -RfT * dt3
        G[:, 3:6, 3:6] = -0.5 * RfT * dt3 * dt3
    else:
        RT = quat_2_rot(imu[:, 0:4]).transpose(-1, -2)
        e = exp_so3(-w_hat * dtc)
        th_bg = -e @ jr_so3(-w_hat * dtc) * dt3
        F[:, 0:3, 0:3] = e
        F[:, 0:3, 9:12] = th_bg
        F[:, 6:9, 0:3] = -RT @ skew(a_hat * dtc)
        F[:, 6:9, 12:15] = -RT * dt3
        F[:, 3:6, 0:3] = -0.5 * RT @ skew(a_hat * dtc * dtc)
        F[:, 3:6, 12:15] = -0.5 * RT * dt3 * dt3
        G[:, 0:3, 0:3] = th_bg
        G[:, 6:9, 3:6] = -RT * dt3
        G[:, 3:6, 3:6] = -0.5 * RT * dt3 * dt3
    F[:, 3:6, 3:6] = I3
    F[:, 3:6, 6:9] = I3 * dt3
    F[:, 6:9, 6:9] = I3
    F[:, 9:12, 9:12] = I3
    F[:, 12:15, 12:15] = I3
    G[:, 9:12, 6:9] = I3
    G[:, 12:15, 9:12] = I3
    return F, G


def predict_and_compute(imu, imu_fej, dt, w1, a1, w2, a2, noises, gravity, opts: PropagatorOptions):
    """One-interval mean + (Φ, Qd); noises = [σ_w², σ_a², σ_wb², σ_ab²]."""
    bg, ba = imu[:, 10:13], imu[:, 13:16]
    w_hat, a_hat = w1 - bg, a1 - ba
    w_hat2, a_hat2 = w2 - bg, a2 - ba
    if opts.use_rk4:
        new_q, new_p, new_v = predict_mean_rk4(imu, dt, w_hat, a_hat, w_hat2, a_hat2, gravity)
    else:
        new_q, new_p, new_v = predict_mean_discrete(imu, dt, w_hat, a_hat, w_hat2, a_hat2, gravity, opts.imu_avg)
    F, G = _phi_g_blocks(imu, imu_fej, new_q, new_p, new_v, dt, w_hat, a_hat, gravity, opts.do_fej)
    # Qd = G Qc Gᵀ, Qc = diag(σ_w²/dt, σ_a²/dt, σ_wb²·dt, σ_ab²·dt) (Trawny eq. 129-130).
    dt_safe = torch.where(dt > 0, dt, torch.ones_like(dt))[:, None]
    qc_diag = torch.cat([
        (noises[0] / dt_safe).expand(-1, 3), (noises[1] / dt_safe).expand(-1, 3),
        (noises[2] * dt_safe).expand(-1, 3), (noises[3] * dt_safe).expand(-1, 3),
    ], dim=1)
    Qd = G @ (qc_diag[:, :, None] * G.transpose(-1, -2))
    Qd = 0.5 * (Qd + Qd.transpose(-1, -2))
    return torch.cat([new_q, new_p, new_v, bg, ba], dim=1), F, Qd


def propagate_mean_cov(imu, imu_fej, imu_t, imu_w, imu_a, t0, t1, noises, gravity, opts: PropagatorOptions):
    """Walk the IMU window's consecutive sample pairs over [t0, t1] (t0, t1 [B];
    imu_t [B, I]; imu_w/a [B, I, 3]). Returns (imu, imu_fej, Φ, Qd, last_w)."""
    B, dtype, dev = imu.shape[0], imu.dtype, imu.device
    phi = torch.eye(15, dtype=dtype, device=dev).expand(B, 15, 15)
    qd = torch.zeros(B, 15, 15, dtype=dtype, device=dev)
    last_w = torch.zeros(B, 3, dtype=dtype, device=dev)

    def lerp(t, ta, tb, va, vb):
        span = tb > ta
        lam = torch.where(span, (t - ta) / torch.where(span, tb - ta, torch.ones_like(ta)), torch.zeros_like(t))
        lam = lam[:, None]
        return (1 - lam) * va + lam * vb

    for n in range(imu_t.shape[1] - 1):
        ta_r, tb_r = imu_t[:, n], imu_t[:, n + 1]
        wa_r, aa_r, wb_r, ab_r = imu_w[:, n], imu_a[:, n], imu_w[:, n + 1], imu_a[:, n + 1]
        ta = torch.minimum(torch.maximum(ta_r, t0), t1)
        tb = torch.minimum(torch.maximum(tb_r, t0), t1)
        dt = tb - ta
        valid = (dt > 0) & torch.isfinite(dt)
        dt_s = torch.where(valid, dt, torch.ones_like(dt))
        w1 = lerp(ta, ta_r, tb_r, wa_r, wb_r)
        a1 = lerp(ta, ta_r, tb_r, aa_r, ab_r)
        w2 = lerp(tb, ta_r, tb_r, wa_r, wb_r)
        a2 = lerp(tb, ta_r, tb_r, aa_r, ab_r)
        new_imu, F, Qd_s = predict_and_compute(imu, imu_fej, dt_s, w1, a1, w2, a2, noises, gravity, opts)
        v1, v3 = valid[:, None], valid[:, None, None]
        last_w = torch.where(v1, w2 - imu[:, 10:13], last_w)
        imu_fej = torch.where(v1, new_imu, imu_fej)
        phi = torch.where(v3, F @ phi, phi)
        qd = torch.where(v3, F @ qd @ F.transpose(-1, -2) + Qd_s, qd)
        imu = torch.where(v1, new_imu, imu)
    return imu, imu_fej, phi, qd, last_w


def _set_slot(x: torch.Tensor, onehot: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """x [B, K, ...] with slot k (onehot [B, K]) replaced by value [B, ...]."""
    sel = onehot.reshape(onehot.shape + (1,) * (x.dim() - 2))
    return torch.where(sel, value[:, None], x)


def propagate_and_clone(state: VioState, imu_t, imu_w, imu_a, t_new, noises, gravity,
                        opts: PropagatorOptions):
    """Frame propagation + stochastic cloning into a recycled slot
    (Propagator::propagate_and_clone + StateHelper::augment_clone).
    Returns (state, slot [B])."""
    lay = state.layout
    t0_imu = state.t + state.last_dt
    t1_imu = t_new + state.calib_dt
    imu_n, fej_n, phi, qd, _ = propagate_mean_cov(
        state.imu, state.imu_fej, imu_t, imu_w, imu_a, t0_imu, t1_imu, noises, gravity, opts)
    cov = ekf.propagate_cov(state.cov, phi, qd)
    slot = torch.argmin(state.clones_t, dim=1)                 # free slots hold -inf
    slot_col = lay.clone_base + 6 * slot
    cov = ekf.zero_slot(cov, slot_col, 6)
    cov = ekf.clone_block(cov, 0, slot_col, 6)
    oh = torch.nn.functional.one_hot(slot, lay.max_clones).bool()
    state = state.replace(
        t=t_new, last_dt=state.calib_dt, imu=imu_n, imu_fej=fej_n, cov=cov,
        clones_q=_set_slot(state.clones_q, oh, imu_n[:, 0:4]),
        clones_p=_set_slot(state.clones_p, oh, imu_n[:, 4:7]),
        clones_q_fej=_set_slot(state.clones_q_fej, oh, fej_n[:, 0:4]),
        clones_p_fej=_set_slot(state.clones_p_fej, oh, fej_n[:, 4:7]),
        clones_t=_set_slot(state.clones_t, oh, t_new),
    )
    return state, slot


def marginalize_oldest_clone(state: VioState, max_clone_size: int) -> VioState:
    """Drop the oldest clone where over budget (StateHelper::marginalize_old_clone)."""
    lay = state.layout
    slot = state.oldest_clone_slot
    over = state.num_clones > max_clone_size
    cov = torch.where(over[:, None, None], ekf.zero_slot(state.cov, lay.clone_base + 6 * slot, 6), state.cov)
    oh = torch.nn.functional.one_hot(slot, lay.max_clones).bool() & over[:, None]
    clones_t = torch.where(oh, torch.full_like(state.clones_t, -float("inf")), state.clones_t)
    return state.replace(cov=cov, clones_t=clones_t)
