"""Plane estimation from sparse points: closed-form fit + joint refinement.

Counterpart of ``ov_plane_tpu/ops/planefit.py`` (all of it but
``plane_ransac``, which comes with ``use_plane_ransac``) over leading batch
dimensions: one plane per stream for the delayed init ([B]), one per stream
and group for the grouped MSCKF update ([B, G]).

* :func:`fit_plane_lsq` — the linear A·x = −1 fit with its condition number
  (PlaneFitting::fit_plane);
* :func:`refine_plane_joint` — the Ceres ``optimize_plane`` as fixed-count
  Levenberg-Marquardt over (features, CP) with Cauchy IRLS weights, the
  features eliminated per iteration by a 3×3 Schur complement, then the
  post-fit inlier re-acceptance;
* :func:`refine_point_on_plane` — features refined against a fixed plane.

CP convention: normal n = cp/‖cp‖, offset d = ‖cp‖, point-on-plane residual
(n·p − d)/σc.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops.ekf import inv3
from ov_plane_tpu_torch.ops.triangulation import eigvals_sym3


class PlaneRefineOptions(NamedTuple):
    iters: int = 10
    lam_init: float = 1e-4
    sigma_px: float = 1.0
    sigma_c: float = 0.05
    slam_sigma_multi: float = 2.0   # inflation for fixed SLAM features (PlaneFitting.cpp:330)
    # Reprojection residuals live in normalized image coordinates, whitened
    # by focal/sigma_px (the reference's sigma_px_norm, UpdaterMSCKF.cpp:279).
    focal: float = 1.0
    # Cauchy scale on the whitened residuals (CauchyLoss(1.0), PlaneFitting.cpp:256,367); 0 disables.
    cauchy_scale: float = 1.0
    # Post-fit re-acceptance (PlaneFitting.cpp:452-495); 0 disables.
    max_error_threshold: float = 0.03
    min_inlier_ratio: float = 0.80


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def fit_plane_lsq(points: torch.Tensor, mask: torch.Tensor):
    """Least-squares plane through the masked points [..., N, 3] (mask
    [..., N]). Returns (cp [..., 3], cond [...], ok [...]): cond =
    sqrt(λmax/λmin) of AᵀA, the reference's singular-value ratio gate."""
    m = mask.to(points.dtype)
    A = points * m[..., None]
    AtA = A.transpose(-1, -2) @ A
    Atb = -torch.sum(A, dim=-2)
    x = (inv3(AtA) @ Atb[..., None])[..., 0]
    eig = eigvals_sym3(AtA)
    cond = torch.sqrt(torch.abs(eig[..., 2]) / torch.clamp(torch.abs(eig[..., 0]), min=1e-18))
    norm_x = _norm(x)
    ok = (mask.sum(dim=-1) >= 3) & (norm_x > 1e-9) & torch.isfinite(x).all(dim=-1)
    # Plane x·p + 1 = 0  ->  n = −x/‖x‖, d = 1/‖x‖, cp = −x/‖x‖².
    cp = -x / torch.clamp(norm_x**2, min=1e-18)[..., None]
    return cp, cond, ok


def _reproj_system(p, uvn, mask, R_GtoC, p_CinG, white_px):
    """Whitened reprojection residuals r [..., N, K, 2] and Jacobians
    J [..., N, K, 2, 3] of the points p [..., N, 3]; R_GtoC [..., 1, K, 3, 3]."""
    p_FinC = (R_GtoC @ (p[..., None, :] - p_CinG)[..., None])[..., 0]
    z = torch.where(torch.abs(p_FinC[..., 2]) < 1e-6, torch.full_like(p_FinC[..., 2], 1e-6), p_FinC[..., 2])
    pred = p_FinC[..., :2] / z[..., None]
    mf = mask.to(p.dtype)
    r = (uvn - pred) * mf[..., None] * white_px
    zero = torch.zeros_like(z)
    dz = torch.stack([
        torch.stack([1.0 / z, zero, -p_FinC[..., 0] / z**2], dim=-1),
        torch.stack([zero, 1.0 / z, -p_FinC[..., 1] / z**2], dim=-1),
    ], dim=-2)
    J = -(dz @ R_GtoC) * mf[..., None, None] * white_px
    return r, J


def _plane_residual(p, cp, white_c):
    """e = wc·(n·p − d) [..., N] and its Jacobians wrt p and cp [..., N, 3]
    (Factor_PointOnPlane); cp [..., 3] is shared by the N points."""
    d = torch.clamp(_norm(cp), min=1e-9)
    n = cp / d[..., None]
    npd = torch.sum(n[..., None, :] * p, dim=-1)
    e = (npd - d[..., None]) * white_c
    J_p = n[..., None, :] * white_c[..., None]
    J_cp = (p - npd[..., None] * n[..., None, :] - d[..., None, None] * n[..., None, :]) \
        / d[..., None, None] * white_c[..., None]
    return e, J_p, J_cp


def refine_plane_joint(cp0, feats0, uvn, mask, feat_valid, is_fixed, R_GtoC, p_CinG, opts: PlaneRefineOptions):
    """Joint LM over (features, cp) with per-iteration Schur elimination.

    cp0 [..., 3]; feats0 [..., N, 3]; uvn [..., N, K, 2]; mask [..., N, K];
    feat_valid / is_fixed [..., N] (fixed features keep their position and
    an inflated constraint sigma); R_GtoC [..., K, 3, 3] and p_CinG
    [..., K, 3] broadcast against the leading dims. Returns (cp, feats, ok,
    inliers [..., N]): features outside ``inliers`` must leave the group;
    ``ok`` is False when fewer than max(4, ⌈min_inlier_ratio·n⌉) remain.
    """
    dtype = cp0.dtype
    white_px = opts.focal / opts.sigma_px
    I3 = torch.eye(3, dtype=dtype, device=cp0.device)
    a2 = opts.cauchy_scale**2
    Rk, pk = R_GtoC[..., None, :, :, :], p_CinG[..., None, :, :]     # [..., 1, K, 3, 3], [..., 1, K, 3]

    def cauchy_w(s):
        # IRLS weight ρ'(s) of ρ(s) = a²·log(1 + s/a²): rows scale by √w.
        if opts.cauchy_scale <= 0.0:
            return torch.ones_like(s)
        return 1.0 / (1.0 + s / a2)

    def rho(s):
        if opts.cauchy_scale <= 0.0:
            return s
        return a2 * torch.log1p(s / a2)

    white_c = torch.where(is_fixed, 1.0 / (opts.slam_sigma_multi * opts.sigma_c),
                          torch.full(is_fixed.shape, 1.0 / opts.sigma_c, dtype=dtype, device=cp0.device))

    def cost(cp_c, feats_c, vf):
        e_re, _ = _reproj_system(feats_c, uvn, mask, Rk, pk, white_px)
        e_pl, _, _ = _plane_residual(feats_c, cp_c, white_c)
        per = (torch.sum(rho(torch.sum(e_re**2, dim=-1)), dim=-1) + rho(e_pl**2)) * vf
        return torch.sum(per, dim=-1)

    cp, feats = cp0, feats0
    lam = torch.full(cp0.shape[:-1], opts.lam_init, dtype=dtype, device=cp0.device)
    frees = ((~is_fixed) & feat_valid).to(dtype)
    for _ in range(opts.iters):
        e_re, A = _reproj_system(feats, uvn, mask, Rk, pk, white_px)   # [..., N, K, 2], [..., N, K, 2, 3]
        sw_re = torch.sqrt(cauchy_w(torch.sum(e_re**2, dim=-1)))       # [..., N, K]
        e_re = e_re * sw_re[..., None]
        A = A * sw_re[..., None, None]
        e_pl, b, c = _plane_residual(feats, cp, white_c)
        sw_pl = torch.sqrt(cauchy_w(e_pl**2))
        e_pl, b, c = e_pl * sw_pl, b * sw_pl[..., None], c * sw_pl[..., None]
        Hff = torch.einsum("...kai,...kaj->...ij", A, A) + b[..., :, None] * b[..., None, :]
        gf = -(torch.einsum("...kai,...ka->...i", A, e_re) + b * e_pl[..., None])
        Hfc = b[..., :, None] * c[..., None, :]
        Hcc_i = c[..., :, None] * c[..., None, :]
        gc_i = -c * e_pl[..., None]

        vf = (feat_valid & torch.isfinite(feats).all(dim=-1)).to(dtype)
        Hff = Hff * vf[..., None, None] + (1 - vf)[..., None, None] * I3
        gf = gf * vf[..., None]
        Hfc = Hfc * vf[..., None, None]
        Hcc_i = Hcc_i * vf[..., None, None]
        gc_i = gc_i * vf[..., None]

        # LM damping on the feature blocks.
        tr_f = torch.clamp(torch.diagonal(Hff, dim1=-2, dim2=-1).sum(-1), min=1e-9)
        Hff_d = Hff + lam[..., None, None, None] * I3 * tr_f[..., None, None] / 3.0
        Hff_inv = inv3(Hff_d)
        # Fixed features feed their plane residual to cp but are not eliminated.
        Hfc_free = Hfc * frees[..., None, None]
        HfcT = Hfc_free.transpose(-1, -2)

        Hcc = torch.sum(Hcc_i, dim=-3) - torch.sum(HfcT @ Hff_inv @ Hfc_free, dim=-3)
        gc = torch.sum(gc_i, dim=-2) - torch.sum((HfcT @ Hff_inv @ (gf * frees[..., None])[..., None])[..., 0], dim=-2)
        tr_c = torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1), min=1e-9)
        Hcc = Hcc + (lam * tr_c / 3.0)[..., None, None] * I3
        dc = (inv3(Hcc) @ gc[..., None])[..., 0]
        df = (Hff_inv @ (gf - (Hfc @ dc[..., None, :, None])[..., 0])[..., None])[..., 0]
        df = df * frees[..., None]

        c_old = cost(cp, feats, vf)
        cp_new = cp + dc
        feats_new = feats + df
        c_new = cost(cp_new, feats_new, vf)
        better = c_new < c_old
        cp = torch.where(better[..., None], cp_new, cp)
        feats = torch.where(better[..., None, None], feats_new, feats)
        lam = torch.where(better, torch.clamp(lam / 10.0, min=1e-10), torch.clamp(lam * 10.0, max=1e6))
    ok = torch.isfinite(cp).all(dim=-1) & (_norm(cp) > 1e-6)

    if opts.max_error_threshold <= 0.0:
        return cp, feats, ok, feat_valid
    # Post-fit re-acceptance: the pre-fit point against the refined plane,
    # a finite refined point in front of its newest observing camera.
    d = torch.clamp(_norm(cp), min=1e-9)
    n = cp / d[..., None]
    err_pre = torch.abs(torch.sum(feats0 * n[..., None, :], dim=-1) - d[..., None])
    finite = torch.isfinite(feats).all(dim=-1)
    K = mask.shape[-1]
    k_idx = torch.argmax(torch.where(mask, torch.arange(K, device=mask.device), -1), dim=-1)  # [..., N]
    R_k = Rk.expand(*mask.shape, 3, 3).gather(-3, k_idx[..., None, None, None].expand(*k_idx.shape, 1, 3, 3))
    p_k = pk.expand(*mask.shape, 3).gather(-2, k_idx[..., None, None].expand(*k_idx.shape, 1, 3))
    p_C = (R_k[..., 0, :, :] @ (feats - p_k[..., 0, :])[..., None])[..., 0]
    front = p_C[..., 2] > 0.1
    inl = feat_valid & (err_pre < opts.max_error_threshold) & finite & (front | is_fixed)
    n_valid = feat_valid.sum(dim=-1)
    # ceil, as the JAX package has it (the C++ original floors).
    need = torch.clamp(torch.ceil(opts.min_inlier_ratio * n_valid.to(torch.float64)).to(torch.int64), min=4)
    ok = ok & (inl.sum(dim=-1) >= need)
    return cp, feats, ok, inl


def refine_point_on_plane(p0, cp, uvn, mask, R_GtoC, p_CinG, opts: PlaneRefineOptions):
    """Levenberg-Marquardt refine of features against a FIXED plane (the
    reference's plane-refined SLAM triangulation): reprojection rows plus one
    point-on-plane row each, ``opts.iters`` damped steps. p0 / cp [..., 3],
    uvn [..., K, 2], mask [..., K], R_GtoC [..., K, 3, 3], p_CinG [..., K, 3].
    Returns the refined points [..., 3]."""
    dtype = p0.dtype
    white_px = opts.focal / opts.sigma_px
    white_c = torch.full(p0.shape[:-1], 1.0 / opts.sigma_c, dtype=dtype, device=p0.device)
    eye = torch.eye(3, dtype=dtype, device=p0.device)
    uvn, mask, R_GtoC, p_CinG = uvn[..., None, :, :], mask[..., None, :], R_GtoC[..., None, :, :, :], p_CinG[..., None, :, :]

    def system(p):
        e_re, A = _reproj_system(p[..., None, :], uvn, mask, R_GtoC, p_CinG, white_px)   # [..., 1, K, 2(, 3)]
        e_pl, b, _ = _plane_residual(p[..., None, :], cp, white_c)                       # [..., 1], [..., 1, 3]
        return e_re[..., 0, :, :], A[..., 0, :, :, :], e_pl[..., 0], b[..., 0, :]

    def cost(p):
        e_re, _, e_pl, _ = system(p)
        return torch.sum(e_re**2, dim=(-1, -2)) + e_pl**2

    p = p0
    lam = torch.full(p0.shape[:-1], opts.lam_init, dtype=dtype, device=p0.device)
    for _ in range(opts.iters):
        e_re, A, e_pl, b = system(p)
        H = torch.einsum("...kai,...kaj->...ij", A, A) + b[..., :, None] * b[..., None, :]
        g = -(torch.einsum("...kai,...ka->...i", A, e_re) + b * e_pl[..., None])
        tr = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1).sum(-1), min=1e-9)
        H = H + (lam * tr / 3.0)[..., None, None] * eye
        dp = (inv3(H) @ g[..., None])[..., 0]
        better = cost(p + dp) < cost(p)
        p = torch.where(better[..., None], p + dp, p)
        lam = torch.where(better, torch.clamp(lam / 10.0, min=1e-10), torch.clamp(lam * 10.0, max=1e6))
    return p
