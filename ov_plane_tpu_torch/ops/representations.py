"""Landmark representations: the six parameterizations of the reference.

Counterpart of ``ov_plane_tpu/ops/representations.py`` (ov_core's
``LandmarkRepresentation``, ``UpdaterHelper::get_feature_jacobian_representation``,
update/UpdaterHelper.cpp:35-193) over any leading batch dimensions.

Each representation maps its parameters to a point in its base frame: the
global frame for the GLOBAL_* reps, the anchor camera frame for the
ANCHORED_* reps (anchor clone pose R_GtoI / p_IinG plus the extrinsic
R_ItoC / p_IinC): p_FinG = R_GtoIᵀ R_ItoCᵀ (p_FinA − p_IinC) + p_IinG.
The JAX package differentiates the perturbation map with ``jacfwd``; here the
same Jacobians are closed forms (held to the JAX ones by
``tests/test_torch_slam.py``), with the filter's JPL attitude error
R ← (I − ⌊δθ⌋) R:

    d p_FinG / d params      = R_CtoG · d p_base / d params
    d p_FinG / d δθ_anchor   = −R_GtoIᵀ ⌊R_ItoCᵀ (p_FinA − p_IinC)⌋
    d p_FinG / d δp_anchor   = I
    d p_FinG / d δθ_extrinsic = −R_GtoIᵀ R_ItoCᵀ ⌊p_FinA − p_IinC⌋
    d p_FinG / d δp_extrinsic = −R_GtoIᵀ R_ItoCᵀ

FEJ semantics follow UpdaterHelper.cpp:92-105: the current best global
estimate is re-expressed in the FEJ anchor frame before linearizing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops.quat import skew

GLOBAL_3D = 0
GLOBAL_FULL_INVERSE_DEPTH = 1
ANCHORED_3D = 2
ANCHORED_FULL_INVERSE_DEPTH = 3
ANCHORED_MSCKF_INVERSE_DEPTH = 4
ANCHORED_INVERSE_DEPTH_SINGLE = 5

_NAMES = {
    "GLOBAL_3D": GLOBAL_3D,
    "GLOBAL_FULL_INVERSE_DEPTH": GLOBAL_FULL_INVERSE_DEPTH,
    "ANCHORED_3D": ANCHORED_3D,
    "ANCHORED_FULL_INVERSE_DEPTH": ANCHORED_FULL_INVERSE_DEPTH,
    "ANCHORED_MSCKF_INVERSE_DEPTH": ANCHORED_MSCKF_INVERSE_DEPTH,
    "ANCHORED_INVERSE_DEPTH_SINGLE": ANCHORED_INVERSE_DEPTH_SINGLE,
}


def from_name(name: str) -> int:
    return _NAMES[name.strip().upper()]


def is_anchored(rep: int) -> bool:
    return rep >= ANCHORED_3D


def dof(rep: int) -> int:
    """Error-state dof of the representation (1 for single inverse depth)."""
    return 1 if rep == ANCHORED_INVERSE_DEPTH_SINGLE else 3


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


class AnchorFrame(NamedTuple):
    """Anchor camera frame = anchor IMU clone pose + IMU->camera extrinsic,
    each with the same leading dimensions."""

    R_GtoI: torch.Tensor   # [..., 3, 3]
    p_IinG: torch.Tensor   # [..., 3]
    R_ItoC: torch.Tensor   # [..., 3, 3]
    p_IinC: torch.Tensor   # [..., 3]

    @property
    def R_CtoG(self) -> torch.Tensor:
        return self.R_GtoI.transpose(-1, -2) @ self.R_ItoC.transpose(-1, -2)

    def point_to_global(self, p_FinA):
        return _mv(self.R_CtoG, p_FinA - self.p_IinC) + self.p_IinG

    def point_to_anchor(self, p_FinG):
        return _mv(self.R_ItoC @ self.R_GtoI, p_FinG - self.p_IinG) + self.p_IinC


# --------------------------------------------------------------------------
# params <-> 3D point in the representation's base frame. Landmark.cpp's
# spherical convention: theta = atan2(y, x), phi = acos(z/|p|), rho = 1/|p|.
# --------------------------------------------------------------------------

def params_from_point(rep: int, p_base):
    """Representation parameters [..., 3] from a point [..., 3] in the base
    frame ([..., 1] for the single-depth rep: rho = 1/z, its fixed bearing
    comes from :func:`single_depth_bearing`)."""
    if rep in (GLOBAL_3D, ANCHORED_3D):
        return p_base
    x, y, z = p_base[..., 0], p_base[..., 1], p_base[..., 2]
    if rep in (GLOBAL_FULL_INVERSE_DEPTH, ANCHORED_FULL_INVERSE_DEPTH):
        rho = 1.0 / torch.sqrt(x * x + y * y + z * z)
        return torch.stack([torch.atan2(y, x), torch.arccos(rho * z), rho], dim=-1)
    if rep == ANCHORED_MSCKF_INVERSE_DEPTH:
        return torch.stack([x / z, y / z, 1.0 / z], dim=-1)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        return (1.0 / z)[..., None]
    raise ValueError(f"unknown representation {rep}")


def single_depth_bearing(p_base):
    """Fixed bearing for ANCHORED_INVERSE_DEPTH_SINGLE: b = p/z (so p = b/rho)."""
    return p_base / p_base[..., 2:3]


def point_from_params(rep: int, params, bearing=None):
    """Point [..., 3] in the base frame from representation parameters."""
    if rep in (GLOBAL_3D, ANCHORED_3D):
        return params
    if rep in (GLOBAL_FULL_INVERSE_DEPTH, ANCHORED_FULL_INVERSE_DEPTH):
        th, phi, rho = params[..., 0], params[..., 1], params[..., 2]
        return torch.stack([torch.cos(th) * torch.sin(phi), torch.sin(th) * torch.sin(phi),
                            torch.cos(phi)], dim=-1) / rho[..., None]
    if rep == ANCHORED_MSCKF_INVERSE_DEPTH:
        return torch.stack([params[..., 0], params[..., 1], torch.ones_like(params[..., 0])],
                           dim=-1) / params[..., 2:3]
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        return bearing / params[..., 0:1]
    raise ValueError(f"unknown representation {rep}")


def point_jacobian(rep: int, params, bearing=None):
    """d point_from_params / d params: [..., 3, dof(rep)]."""
    if rep in (GLOBAL_3D, ANCHORED_3D):
        return torch.eye(3, dtype=params.dtype, device=params.device).expand(*params.shape[:-1], 3, 3)
    if rep in (GLOBAL_FULL_INVERSE_DEPTH, ANCHORED_FULL_INVERSE_DEPTH):
        th, phi, rho = params[..., 0], params[..., 1], params[..., 2]
        ct, st, cph, sph = torch.cos(th), torch.sin(th), torch.cos(phi), torch.sin(phi)
        d_th = torch.stack([-st * sph, ct * sph, torch.zeros_like(th)], dim=-1) / rho[..., None]
        d_phi = torch.stack([ct * cph, st * cph, -sph], dim=-1) / rho[..., None]
        d_rho = -torch.stack([ct * sph, st * sph, cph], dim=-1) / (rho * rho)[..., None]
        return torch.stack([d_th, d_phi, d_rho], dim=-1)
    if rep == ANCHORED_MSCKF_INVERSE_DEPTH:
        a, b, rho = params[..., 0], params[..., 1], params[..., 2]
        z, inv = torch.zeros_like(a), 1.0 / rho
        d_rho = -torch.stack([a, b, torch.ones_like(a)], dim=-1) / (rho * rho)[..., None]
        return torch.stack([torch.stack([inv, z, z], dim=-1), torch.stack([z, inv, z], dim=-1), d_rho], dim=-1)
    if rep == ANCHORED_INVERSE_DEPTH_SINGLE:
        rho = params[..., 0:1]
        return (-bearing / (rho * rho))[..., None]
    raise ValueError(f"unknown representation {rep}")


def rep_to_global(rep: int, params, anchor: AnchorFrame | None = None, bearing=None):
    p_base = point_from_params(rep, params, bearing)
    return anchor.point_to_global(p_base) if is_anchored(rep) else p_base


def global_to_rep(rep: int, p_FinG, anchor: AnchorFrame | None = None):
    p_base = anchor.point_to_anchor(p_FinG) if is_anchored(rep) else p_FinG
    return params_from_point(rep, p_base)


# --------------------------------------------------------------------------
# Error-state Jacobians (the get_feature_jacobian_representation equivalent).
# --------------------------------------------------------------------------

class RepJacobians(NamedTuple):
    p_FinG: torch.Tensor    # linearization-point global position [..., 3]
    H_f: torch.Tensor       # d p_FinG / d params             [..., 3, dof]
    H_anchor: torch.Tensor  # d p_FinG / d (dth, dp) anchor   [..., 3, 6] (zero for global reps)
    H_calib: torch.Tensor   # d p_FinG / d (dth, dp) extrinsic [..., 3, 6] (zero unless calib_extrinsic)


def rep_jacobians(rep: int, p_FinG, p_FinG_fej, anchor: AnchorFrame | None, anchor_fej: AnchorFrame | None,
                  fej: bool = True, calib_extrinsic: bool = False) -> RepJacobians:
    """All representation Jacobians at the linearization point (semantics of
    UpdaterHelper.cpp:35-193): global reps give H_f only; anchored reps
    also the anchor-clone block and, with ``calib_extrinsic``, the
    extrinsic block. With ``fej`` the global reps linearize at the FEJ
    point and the anchored ones re-anchor the current point in the FEJ
    anchor frame."""
    z6 = torch.zeros(p_FinG.shape[:-1] + (3, 6), dtype=p_FinG.dtype, device=p_FinG.device)
    if not is_anchored(rep):
        params = params_from_point(rep, p_FinG_fej if fej else p_FinG)
        return RepJacobians(point_from_params(rep, params), point_jacobian(rep, params), z6, z6)

    anc = anchor_fej if fej else anchor
    p_FinA = anc.point_to_anchor(p_FinG)
    params = params_from_point(rep, p_FinA)
    bearing = single_depth_bearing(p_FinA) if rep == ANCHORED_INVERSE_DEPTH_SINGLE else None
    w = point_from_params(rep, params, bearing) - anc.p_IinC           # p_A − p_IinC
    R_GtoI_T = anc.R_GtoI.transpose(-1, -2)
    R_CtoG = R_GtoI_T @ anc.R_ItoC.transpose(-1, -2)
    v = _mv(anc.R_ItoC.transpose(-1, -2), w)                           # the point in the anchor IMU frame
    p_lin = _mv(R_CtoG, w) + anc.p_IinG
    H_f = R_CtoG @ point_jacobian(rep, params, bearing)
    H_th = -(R_GtoI_T @ skew(v))
    H_anchor = torch.cat([H_th, torch.eye(3, dtype=H_th.dtype, device=H_th.device).expand(H_th.shape)], dim=-1)
    H_calib = z6
    if calib_extrinsic:
        H_calib = torch.cat(torch.broadcast_tensors(-(R_CtoG @ skew(w)), -R_CtoG), dim=-1)
    return RepJacobians(p_lin, H_f, H_anchor, H_calib)
