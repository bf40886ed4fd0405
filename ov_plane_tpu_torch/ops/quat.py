"""JPL quaternion and SO(3) operations (PyTorch).

Counterpart of ``ov_plane_tpu/ops/quat.py``. Conventions (Trawny &
Roumeliotis, same as the reference):

* quaternions are JPL ``q = [x, y, z, w]`` with the scalar last;
* ``q`` represents the global-to-local rotation, ``R(q) = R_GtoL``;
* ``quat_multiply(q, p)`` satisfies ``R(q ⊗ p) = R(q) R(p)``.

Every function broadcasts over leading batch dimensions. Small-angle limits
are where-guarded on θ² (never on ``norm``), as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """⌊v⌋ with ⌊v⌋u = v × u. (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_norm(q: torch.Tensor) -> torch.Tensor:
    """Normalize a JPL quaternion and make its scalar part non-negative."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_2_rot(q: torch.Tensor) -> torch.Tensor:
    """JPL quaternion -> R_GtoL: R = (2w² − 1) I − 2w ⌊q_v⌋ + 2 q_v q_vᵀ."""
    qv = q[..., :3]
    w = q[..., 3]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    outer = qv[..., :, None] * qv[..., None, :]
    return (
        (2.0 * w**2 - 1.0)[..., None, None] * eye
        - 2.0 * w[..., None, None] * skew(qv)
        + 2.0 * outer
    )


def rot_2_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> JPL quaternion, branch-free max-trace selection."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    tw = safe_sqrt(1.0 + tr)
    qw = torch.stack([(r12 - r21) / (2 * tw), (r20 - r02) / (2 * tw), (r01 - r10) / (2 * tw), 0.5 * tw], dim=-1)
    tx = safe_sqrt(1.0 + 2 * r00 - tr)
    qx = torch.stack([0.5 * tx, (r01 + r10) / (2 * tx), (r02 + r20) / (2 * tx), (r12 - r21) / (2 * tx)], dim=-1)
    ty = safe_sqrt(1.0 + 2 * r11 - tr)
    qy = torch.stack([(r01 + r10) / (2 * ty), 0.5 * ty, (r12 + r21) / (2 * ty), (r20 - r02) / (2 * ty)], dim=-1)
    tz = safe_sqrt(1.0 + 2 * r22 - tr)
    qz = torch.stack([(r02 + r20) / (2 * tz), (r12 + r21) / (2 * tz), 0.5 * tz, (r01 - r10) / (2 * tz)], dim=-1)

    cond_w = (tr >= r00) & (tr >= r11) & (tr >= r22)
    cond_x = (r00 >= tr) & (r00 >= r11) & (r00 >= r22)
    cond_y = (r11 >= tr) & (r11 >= r00) & (r11 >= r22)
    q = torch.where(cond_w[..., None], qw,
                    torch.where(cond_x[..., None], qx, torch.where(cond_y[..., None], qy, qz)))
    return quat_norm(q)


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """JPL product q ⊗ p, normalized."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    out = torch.stack(
        [
            qw * px + qz * py - qy * pz + qx * pw,
            -qz * px + qw * py + qx * pz + qy * pw,
            qy * px - qx * py + qw * pz + qz * pw,
            -qx * px - qy * py - qz * pz + qw * pw,
        ],
        dim=-1,
    )
    return quat_norm(out)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse (conjugate) of a unit JPL quaternion."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def omega(w: torch.Tensor) -> torch.Tensor:
    """Ω(ω) with q̇ = ½ Ω(ω) q. (..., 3) -> (..., 4, 4)."""
    top = torch.cat([-skew(w), w[..., :, None]], dim=-1)
    bot = torch.cat([-w[..., None, :], torch.zeros_like(w[..., :1, None])], dim=-1)
    return torch.cat([top, bot], dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues), guarded on θ² < 1e-14."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-14
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    theta_s = torch.sqrt(theta2_s)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_s) / theta_s)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_s)) / theta2_s)
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm through the quaternion: w = −θ·q_v/‖q_v‖."""
    q = rot_2_quat(R)
    qv = q[..., 0:3]
    qw = q[..., 3]
    nv = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(nv, qw)
    small = nv < 1e-12
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12),
                        theta / torch.where(small, torch.ones_like(nv), nv))
    return -qv * scale[..., None]


def jr_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), guarded on θ² < 1e-14."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-14
    theta2_s = torch.where(small, torch.ones_like(theta2), theta2)
    safe = torch.sqrt(theta2_s)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / theta2_s)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (theta2_s * safe))
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - B[..., None, None] * W + C[..., None, None] * (W @ W)
