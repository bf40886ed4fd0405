"""Batched feature triangulation: linear init + Levenberg-Marquardt refinement.

Counterpart of ``ov_plane_tpu/ops/triangulation.py``. Inputs carry leading
dimensions [B, F] (streams, features); the clone/camera poses are per stream
[B, K, ...] and broadcast over the features.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops.ekf import inv3


class TriangulationOptions(NamedTuple):
    min_dist: float = 0.10
    max_dist: float = 60.0
    max_cond: float = 10000.0
    refine: bool = True
    max_runs: int = 5
    init_lamda: float = 1e-3
    max_lamda: float = 1e10
    lam_mult: float = 10.0
    min_obs: int = 2


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form ascending eigenvalues of symmetric [..., 3, 3]."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    Bm = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(Bm * Bm, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-300))
    detB = (
        Bm[..., 0, 0] * (Bm[..., 1, 1] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 1])
        - Bm[..., 0, 1] * (Bm[..., 1, 0] * Bm[..., 2, 2] - Bm[..., 1, 2] * Bm[..., 2, 0])
        + Bm[..., 0, 2] * (Bm[..., 1, 0] * Bm[..., 2, 1] - Bm[..., 1, 1] * Bm[..., 2, 0])
    )
    r = torch.clamp(detB / (2 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2 * p * torch.cos(phi)
    l3 = q + 2 * p * torch.cos(phi + 2 * math.pi / 3.0)
    l2 = 3 * q - l1 - l3
    return torch.stack([l3, l2, l1], dim=-1)


def _depths(R_GtoC, p_CinG, p):
    """Camera-frame z of point p [B, F, 3] in every clone: [B, F, K]."""
    return torch.einsum("bkj,bfkj->bfk", R_GtoC[:, :, 2, :], p[:, :, None, :] - p_CinG[:, None])


def triangulate_linear(uvn, mask, R_GtoC, p_CinG, opts: TriangulationOptions):
    """Midpoint triangulation. uvn [B, F, K, 2], mask [B, F, K], R_GtoC
    [B, K, 3, 3], p_CinG [B, K, 3]. Returns (p [B, F, 3], valid [B, F])."""
    m = mask.to(uvn.dtype)
    bear_c = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    bear_g = torch.einsum("bkji,bfkj->bfki", R_GtoC, bear_c)
    bear_g = bear_g / torch.linalg.vector_norm(bear_g, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=uvn.dtype, device=uvn.device)
    proj = (eye - bear_g[..., :, None] * bear_g[..., None, :]) * m[..., None, None]  # [B, F, K, 3, 3]
    A = proj.sum(dim=2)
    b = torch.einsum("bfkij,bkj->bfi", proj, p_CinG)
    p = (inv3(A) @ b[..., None])[..., 0]
    eig = eigvals_sym3(A)
    e0 = eig[..., 0]
    cond = eig[..., 2] / torch.where(torch.abs(e0) < 1e-12, torch.full_like(e0, 1e-12), e0)
    depths = _depths(R_GtoC, p_CinG, p)
    n_obs = mask.sum(dim=-1)
    depth_ok = torch.where(mask, (depths > opts.min_dist) & (depths < opts.max_dist), True).all(dim=-1)
    valid = (n_obs >= opts.min_obs) & (cond <= opts.max_cond) & depth_ok & torch.isfinite(p).all(dim=-1)
    return p, valid


def _reproj(p, uvn, mask, R_GtoC, p_CinG):
    p_FinC = torch.einsum("bkij,bfkj->bfki", R_GtoC, p[:, :, None, :] - p_CinG[:, None])
    z = p_FinC[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    pred = p_FinC[..., :2] / z_safe[..., None]
    r = (uvn - pred) * mask[..., None].to(uvn.dtype)
    return r, p_FinC, z_safe


def refine_gauss_newton(p0, uvn, mask, R_GtoC, p_CinG, opts: TriangulationOptions):
    """Fixed-iteration LM on global-3D reprojection (single_gaussnewton)."""
    def cost(p):
        r, _, _ = _reproj(p, uvn, mask, R_GtoC, p_CinG)
        return torch.sum(r * r, dim=(-1, -2))

    mf = mask.to(uvn.dtype)
    p = p0
    lam = torch.full(p0.shape[:-1], opts.init_lamda, dtype=p0.dtype, device=p0.device)
    c = cost(p)
    for _ in range(opts.max_runs):
        r, p_FinC, z = _reproj(p, uvn, mask, R_GtoC, p_CinG)
        zero = torch.zeros_like(z)
        dz = torch.stack([
            torch.stack([1.0 / z, zero, -p_FinC[..., 0] / z**2], dim=-1),
            torch.stack([zero, 1.0 / z, -p_FinC[..., 1] / z**2], dim=-1),
        ], dim=-2)                                                  # [B, F, K, 2, 3]
        J = -torch.einsum("bfkac,bkcd->bfkad", dz, R_GtoC) * mf[..., None, None]
        JtJ = torch.einsum("bfkai,bfkaj->bfij", J, J)
        Jtr = torch.einsum("bfkai,bfka->bfi", J, r)
        A = JtJ + lam[..., None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1))
        dp = -(inv3(A) @ Jtr[..., None])[..., 0]
        p_new = p + dp
        c_new = cost(p_new)
        better = c_new < c
        p = torch.where(better[..., None], p_new, p)
        lam = torch.where(better, torch.clamp(lam / opts.lam_mult, min=1e-12),
                          torch.clamp(lam * opts.lam_mult, max=opts.max_lamda))
        c = torch.where(better, c_new, c)
    return p


def triangulate(uvn, mask, R_GtoC, p_CinG, opts: TriangulationOptions):
    """Linear + optional refinement for [B, F] features. Returns (p [B, F, 3], valid [B, F])."""
    p_lin, valid = triangulate_linear(uvn, mask, R_GtoC, p_CinG, opts)
    p_lin = torch.where(valid[..., None], p_lin, torch.ones_like(p_lin))   # safe dummy
    if not opts.refine:
        return p_lin, valid
    p_ref = refine_gauss_newton(p_lin, uvn, mask, R_GtoC, p_CinG, opts)
    depths = _depths(R_GtoC, p_CinG, p_ref)
    ok = torch.where(mask, (depths > opts.min_dist) & (depths < opts.max_dist), True).all(dim=-1)
    ok = ok & torch.isfinite(p_ref).all(dim=-1)
    return torch.where(ok[..., None], p_ref, p_lin), valid & ok
