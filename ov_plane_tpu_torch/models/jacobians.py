"""Per-feature stacked measurement Jacobians (full-width, GLOBAL_3D).

Counterpart of ``ov_plane_tpu/models/jacobians.py`` for GLOBAL_3D features
without calibration columns. One feature gives a fixed-shape system over the
K clone slots:

    rows [0 : 2K)    whitened reprojection residuals (2 per clone slot)
    rows [2K : 3K)   point-on-plane rows, all zero until the plane slice
                     of the port fills them (the JAX layout is kept, so the
                     stacked update has the same row count M·(3K−3))

H_x [.., 3K, D] is full width over the state layout, H_f [.., 3K, 6] holds
d/d p_FinG in columns 0:3. FEJ points follow the reference: clone FEJ poses
and the feature FEJ value in the Jacobians, current estimates in the
residuals and in the distortion Jacobian.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops.quat import quat_2_rot, skew
from ov_plane_tpu_torch.state.layout import StateLayout


class JacobianOptions(NamedTuple):
    cam_model: int = cams.RADTAN
    do_fej: bool = True


class CloneSet(NamedTuple):
    """Per-frame clone/camera data shared by the features of each stream."""

    R_GtoI: torch.Tensor      # [B, K, 3, 3]
    p_IinG: torch.Tensor      # [B, K, 3]
    R_GtoI_fej: torch.Tensor  # [B, K, 3, 3]
    p_IinG_fej: torch.Tensor  # [B, K, 3]
    R_ItoC: torch.Tensor      # [B, 3, 3]
    p_IinC: torch.Tensor      # [B, 3]
    zeta: torch.Tensor        # [B, 8]

    @property
    def R_GtoC(self):
        return self.R_ItoC[:, None] @ self.R_GtoI

    @property
    def p_CinG(self):
        # camera center: p_IinG − R_GtoIᵀ R_ItoCᵀ p_IinC
        RT = self.R_GtoI.transpose(-1, -2) @ self.R_ItoC.transpose(-1, -2)[:, None]
        return self.p_IinG - (RT @ self.p_IinC[:, None, :, None])[..., 0]


def clone_set_from_state(state) -> CloneSet:
    return CloneSet(
        R_GtoI=quat_2_rot(state.clones_q), p_IinG=state.clones_p,
        R_GtoI_fej=quat_2_rot(state.clones_q_fej), p_IinG_fej=state.clones_p_fej,
        R_ItoC=quat_2_rot(state.calib_cam[:, 0:4]), p_IinC=state.calib_cam[:, 4:7],
        zeta=state.cam_zeta,
    )


def feature_jacobian_full(lay: StateLayout, opts: JacobianOptions, clones: CloneSet,
                          uv, obs_mask, p_FinG, p_FinG_fej, sigma_px):
    """Stacked whitened systems of [B, M] features.

    uv [B, M, K, 2] measured pixels, obs_mask [B, M, K], p_FinG / p_FinG_fej
    [B, M, 3]. Returns (H_x [B, M, 3K, D], H_f [B, M, 3K, 6], res [B, M, 3K],
    row_mask [B, M, 3K]).
    """
    B, M, K = obs_mask.shape
    D = lay.dim
    dtype, dev = uv.dtype, uv.device
    white_px = 1.0 / sigma_px
    R_ItoC = clones.R_ItoC[:, None, None]                       # [B, 1, 1, 3, 3]
    p_IinC = clones.p_IinC[:, None, None]                       # [B, 1, 1, 3]
    zeta = clones.zeta[:, None, None]

    def cam_point(R_GtoI, p_IinG, pf):
        p_FinI = (R_GtoI[:, None] @ (pf[:, :, None, :] - p_IinG[:, None])[..., None])[..., 0]
        return p_FinI, (R_ItoC @ p_FinI[..., None])[..., 0] + p_IinC

    p_FinIi, p_FinCi = cam_point(clones.R_GtoI, clones.p_IinG, p_FinG)   # [B, M, K, 3]
    z = p_FinCi[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    uv_norm = p_FinCi[..., :2] / z[..., None]
    uv_dist, dz_dzn, _ = cams.distort_jacobians(uv_norm, zeta, opts.cam_model)
    r = white_px * (uv - uv_dist)                               # [B, M, K, 2]

    if opts.do_fej:
        R_j = clones.R_GtoI_fej
        p_FinIi_j, p_FinCi_j = cam_point(R_j, clones.p_IinG_fej, p_FinG_fej)
    else:
        R_j = clones.R_GtoI
        p_FinIi_j, p_FinCi_j = p_FinIi, p_FinCi
    zj = p_FinCi_j[..., 2]
    zj = torch.where(torch.abs(zj) < 1e-6, torch.full_like(zj, 1e-6), zj)
    zero = torch.zeros_like(zj)
    dzn_dpfc = torch.stack([
        torch.stack([1.0 / zj, zero, -p_FinCi_j[..., 0] / zj**2], dim=-1),
        torch.stack([zero, 1.0 / zj, -p_FinCi_j[..., 1] / zj**2], dim=-1),
    ], dim=-2)                                                  # [B, M, K, 2, 3]
    dpfc_dpfg = R_ItoC @ R_j[:, None]                           # [B, M, K, 3, 3] (broadcast)
    dz_dpfc = dz_dzn @ dzn_dpfc
    dz_dpfg = dz_dpfc @ dpfc_dpfg
    dpfc_dclone = torch.cat([R_ItoC @ skew(p_FinIi_j), -dpfc_dpfg.expand(B, M, K, 3, 3)], dim=-1)
    mf = obs_mask.to(dtype)[..., None, None]
    H_clone = white_px * (dz_dpfc @ dpfc_dclone) * mf           # [B, M, K, 2, 6]
    H_feat = white_px * dz_dpfg * mf                            # [B, M, K, 2, 3]
    r = r * mf[..., 0]

    eyeK = torch.eye(K, dtype=dtype, device=dev)
    Hc_bd = torch.einsum("bmkac,kl->bmkalc", H_clone, eyeK).reshape(B, M, 2 * K, 6 * K)
    H_x = torch.zeros(B, M, 3 * K, D, dtype=dtype, device=dev)
    H_x[:, :, :2 * K, lay.clone_base:lay.clone_base + 6 * K] = Hc_bd
    H_f = torch.zeros(B, M, 3 * K, 6, dtype=dtype, device=dev)
    H_f[:, :, :2 * K, 0:3] = H_feat.reshape(B, M, 2 * K, 3)
    res = torch.zeros(B, M, 3 * K, dtype=dtype, device=dev)
    res[:, :, :2 * K] = r.reshape(B, M, 2 * K)
    row_mask = torch.zeros(B, M, 3 * K, dtype=torch.bool, device=dev)
    row_mask[:, :, :2 * K] = obs_mask.repeat_interleave(2, dim=-1)
    return H_x, H_f, res, row_mask
