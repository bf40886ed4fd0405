"""Per-feature stacked measurement Jacobians (full-width).

Counterpart of ``ov_plane_tpu/models/jacobians.py`` without calibration
columns. One feature gives a fixed-shape system over the K clone slots:

    rows [0 : 2K)    whitened reprojection residuals (2 per clone slot)
    rows [2K : 3K)   whitened point-on-plane residuals (1 per observation,
                     only for a feature on a plane, UpdaterHelper.cpp:448-512)

H_x [.., 3K, D] is full width over the state layout; H_f [.., 3K, 6] holds
d/d p_FinG in columns 0:3 and d/d cp in columns 3:6 for a plane that is not
in the state (a plane in the state takes its three state columns in H_x).
FEJ points follow the reference: clone FEJ poses and the feature / plane FEJ
values in the Jacobians, current estimates in the residuals and in the
distortion Jacobian. With a landmark representation other than GLOBAL_3D
(``JacobianOptions.rep``) the feature columns are that representation's
error state, and anchored representations add the coupling to their anchor
clone's columns (UpdaterHelper.cpp:195-444).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models.feature_bank import _take
from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.ops.quat import quat_2_rot, skew
from ov_plane_tpu_torch.state.layout import StateLayout


class JacobianOptions(NamedTuple):
    cam_model: int = cams.RADTAN
    do_fej: bool = True
    # Landmark representation of the feature error state (ops/representations;
    # the 1-dof ANCHORED_INVERSE_DEPTH_SINGLE does not fit the 3-column H_f).
    rep: int = reps.GLOBAL_3D


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


def anchor_frames(clones: CloneSet, slot: torch.Tensor):
    """(current, FEJ) anchor camera frames of clone slots [B, M] (in range)."""
    B, M = slot.shape
    R_ItoC = clones.R_ItoC[:, None].expand(B, M, 3, 3)
    p_IinC = clones.p_IinC[:, None].expand(B, M, 3)
    return (reps.AnchorFrame(_take(clones.R_GtoI, slot), _take(clones.p_IinG, slot), R_ItoC, p_IinC),
            reps.AnchorFrame(_take(clones.R_GtoI_fej, slot), _take(clones.p_IinG_fej, slot), R_ItoC, p_IinC))


def safe_anchor_point(p_A: torch.Tensor):
    """A degenerate anchor-frame point (not finite, behind the camera or at its
    centre) replaced by the unit forward point, so inverse-depth parameters
    stay finite; such features are gated out downstream. Returns (p_A, ok)."""
    ok = torch.isfinite(p_A).all(dim=-1) & (p_A[..., 2] > 1e-3) & (torch.linalg.vector_norm(p_A, dim=-1) > 1e-3)
    fwd = torch.tensor([0.0, 0.0, 1.0], dtype=p_A.dtype, device=p_A.device)
    return torch.where(ok[..., None], p_A, fwd), ok


def feature_jacobian_full(lay: StateLayout, opts: JacobianOptions, clones: CloneSet,
                          uv, obs_mask, p_FinG, p_FinG_fej, sigma_px,
                          cp=None, cp_fej=None, has_plane=None, plane_in_state=None, plane_slot=None,
                          sigma_c=0.05, anchor_slot=None):
    """Stacked whitened systems of [B, M] features.

    uv [B, M, K, 2] measured pixels, obs_mask [B, M, K], p_FinG / p_FinG_fej
    [B, M, 3]. With ``has_plane`` [B, M] given, the point-on-plane rows are
    filled for the features on a plane: cp / cp_fej [B, M, 3] the plane's CP,
    plane_in_state [B, M] and plane_slot [B, M] int its state slot, sigma_c a
    float or [B, M]. With ``opts.rep`` other than GLOBAL_3D, ``anchor_slot``
    [B, M] (clone slots in range) anchors each feature's representation.
    Returns (H_x [B, M, 3K, D], H_f [B, M, 3K, 6], res [B, M, 3K],
    row_mask [B, M, 3K]).
    """
    B, M, K = obs_mask.shape
    D = lay.dim
    dtype, dev = uv.dtype, uv.device
    white_px = 1.0 / sigma_px
    rj = None
    if opts.rep != reps.GLOBAL_3D:
        anchor_slot = anchor_slot.to(torch.int64)
        anc, anc_fej = anchor_frames(clones, anchor_slot)
        # A failed triangulation can put the point at the anchor camera's
        # centre or behind it, where inverse-depth parameters are not finite
        # (and 0·NaN survives the masks): linearize at the unit forward point.
        p_FinG = anc.point_to_global(safe_anchor_point(anc.point_to_anchor(p_FinG))[0])
        fej_frame = anc_fej if opts.do_fej else anc
        p_FinG_fej = fej_frame.point_to_global(safe_anchor_point(fej_frame.point_to_anchor(p_FinG_fej))[0])
        rj = reps.rep_jacobians(opts.rep, p_FinG, p_FinG_fej, anc, anc_fej, fej=opts.do_fej)
        # FEJ overwrite (UpdaterHelper.cpp:376-385): the projection is
        # linearized at the representation's re-anchored FEJ point.
        p_FinG_fej = rj.p_FinG
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
    if rj is not None:
        # Chain rule into the representation's error state; anchored reps
        # add d z / d(anchor pose) at the anchor clone's six columns.
        if reps.is_anchored(opts.rep):
            Ha_rows = (H_feat @ rj.H_anchor[:, :, None]).reshape(B, M, 2 * K, 6)
            col0 = lay.clone_base + 6 * anchor_slot                          # [B, M]
            j = torch.arange(D, device=dev)
            k_of = (j - col0[..., None]).clamp(0, 5)                         # [B, M, D]
            in_cols = (j >= col0[..., None]) & (j < col0[..., None] + 6)
            spread = Ha_rows.gather(-1, k_of[:, :, None, :].expand(B, M, 2 * K, D))
            H_x[:, :, :2 * K] = H_x[:, :, :2 * K] + torch.where(in_cols[:, :, None, :], spread, 0.0)
        H_feat = H_feat @ rj.H_f[:, :, None]
    H_f = torch.zeros(B, M, 3 * K, 6, dtype=dtype, device=dev)
    H_f[:, :, :2 * K, 0:3] = H_feat.reshape(B, M, 2 * K, 3)
    res = torch.zeros(B, M, 3 * K, dtype=dtype, device=dev)
    res[:, :, :2 * K] = r.reshape(B, M, 2 * K)
    row_mask = torch.zeros(B, M, 3 * K, dtype=torch.bool, device=dev)
    row_mask[:, :, :2 * K] = obs_mask.repeat_interleave(2, dim=-1)
    if has_plane is None:
        return H_x, H_f, res, row_mask

    # Point-on-plane rows (UpdaterHelper.cpp:448-512).
    if isinstance(sigma_c, torch.Tensor):
        white_c = (1.0 / sigma_c).expand(B, M)
    else:
        white_c = torch.full((B, M), 1.0 / sigma_c, dtype=dtype, device=dev)
    d_cur = torch.linalg.vector_norm(cp, dim=-1)
    d_cur = torch.where(d_cur < 1e-9, torch.full_like(d_cur, 1e-9), d_cur)
    n_cur = cp / d_cur[..., None]
    r_plane = white_c * (0.0 - (torch.sum(n_cur * p_FinG, dim=-1) - d_cur))       # [B, M]
    if opts.do_fej:
        pf_j = p_FinG_fej
        d_j = torch.linalg.vector_norm(cp_fej, dim=-1)
        d_j = torch.where(d_j < 1e-9, torch.full_like(d_j, 1e-9), d_j)
        n_j = cp_fej / d_j[..., None]
    else:
        pf_j, d_j, n_j = p_FinG, d_cur, n_cur
    npf = torch.sum(n_j * pf_j, dim=-1)
    H_cp_row = (white_c / d_j)[..., None] * (pf_j - npf[..., None] * n_j - d_j[..., None] * n_j)  # [B, M, 3]
    H_f_plane_row = white_c[..., None] * n_j

    rows_mask = obs_mask & has_plane[..., None]                               # [B, M, K]
    mrow = rows_mask.to(dtype)[..., None]
    res[:, :, 2 * K:] = r_plane[..., None] * rows_mask.to(dtype)
    row_mask[:, :, 2 * K:] = rows_mask
    H_f[:, :, 2 * K:, 0:3] = H_f_plane_row[:, :, None, :] * mrow
    in_state = (plane_in_state & has_plane)[..., None, None]                 # [B, M, 1, 1]
    H_cp = H_cp_row[:, :, None, :] * mrow                                    # [B, M, K, 3]
    H_f[:, :, 2 * K:, 3:6] = torch.where(in_state, 0.0, H_cp)
    # The plane state's three columns, by a mask over D (the slot is per feature).
    col0 = lay.plane_base + 3 * plane_slot.to(torch.int64)                   # [B, M]
    j = torch.arange(D, device=dev)
    k_of = (j - col0[..., None]).clamp(0, 2)                                 # [B, M, D]
    in_cols = (j >= col0[..., None]) & (j < col0[..., None] + 3)
    spread = H_cp.gather(-1, k_of[:, :, None, :].expand(B, M, K, D))        # [B, M, K, D]
    H_x[:, :, 2 * K:, :] = torch.where(in_state & in_cols[:, :, None, :], spread, 0.0)
    return H_x, H_f, res, row_mask
