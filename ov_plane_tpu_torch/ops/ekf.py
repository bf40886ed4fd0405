"""EKF covariance operations on the static state layout, for B streams.

Counterpart of ``ov_plane_tpu/ops/ekf.py`` (the parts the filter runs). The
covariance is one ``[B, D, D]`` tensor over a fixed layout; slots are
recycled by zeroing rows/columns, and masked measurement rows are all-zero
rows of H with zero residual and unit noise, which leave every result
untouched. Slot starts that differ per stream are ``[B]`` tensors and are
applied with gathers and masks, so every index stays in range.
"""

from __future__ import annotations

import torch

from ov_plane_tpu_torch.ops import kernels
from ov_plane_tpu_torch.ops.quat import quat_multiply, quat_norm


def cholesky_or_nan(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails.

    ``torch.linalg.cholesky`` raises on a matrix that is not positive
    definite, where the JAX package gets NaN and routes on it (χ² gates fail,
    the information form falls back to zero information).
    """
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def propagate_cov(cov: torch.Tensor, phi: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """P ← Φ P Φᵀ + Q on the leading IMU rows/cols (StateHelper::EKFPropagation)."""
    n = phi.shape[-1]
    cov_phiT = cov[:, :, :n] @ phi.transpose(-1, -2)           # [B, D, n]
    phi_cov_phiT = phi @ cov_phiT[:, :n, :] + qd               # [B, n, n]
    cov = cov.clone()
    cov[:, :n, :] = cov_phiT.transpose(-1, -2)
    cov[:, :, :n] = cov_phiT
    cov[:, :n, :n] = 0.5 * (phi_cov_phiT + phi_cov_phiT.transpose(-1, -2))
    return cov


def _slot_mask(dim: int, start: torch.Tensor, size: int) -> torch.Tensor:
    """[B, D] bool: True on [start, start + size)."""
    idx = torch.arange(dim, device=start.device)
    return (idx[None, :] >= start[:, None]) & (idx[None, :] < start[:, None] + size)


def zero_slot(cov: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Marginalize a slot: zero its rows and columns (start [B])."""
    keep = (~_slot_mask(cov.shape[-1], start, size)).to(cov.dtype)
    return cov * keep[:, None, :] * keep[:, :, None]


def write_slot(cov: torch.Tensor, start: torch.Tensor, cross: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """Write a c-wide slot at per-stream start [B]: its columns take cross
    [B, D, c], its rows crossᵀ, its diagonal block blk [B, c, c]."""
    B, D, _ = cov.shape
    c = blk.shape[-1]
    in_slot = _slot_mask(D, start, c)                                    # [B, D]
    k_of = (torch.arange(D, device=cov.device)[None, :] - start[:, None]).clamp(0, c - 1)
    col_sel = cross.gather(2, k_of[:, None, :].expand(B, D, D))          # cross[b, i, k(j)]
    cov = torch.where(in_slot[:, None, :], col_sel, cov)
    cov = torch.where(in_slot[:, :, None], col_sel.transpose(1, 2), cov)
    blk_rows = blk.gather(1, k_of[:, :, None].expand(B, D, c))
    blk_sel = blk_rows.gather(2, k_of[:, None, :].expand(B, D, D))
    return torch.where(in_slot[:, :, None] & in_slot[:, None, :], blk_sel, cov)


def clone_block(cov: torch.Tensor, src: int, dst: torch.Tensor, size: int) -> torch.Tensor:
    """Stochastic cloning: copy rows/cols [src, src+size) into slot dst [B]
    (StateHelper::clone). The dst slot must be zero beforehand."""
    return write_slot(cov, dst, cov[:, :, src:src + size], cov[:, src:src + size, src:src + size])


def kalman_update(cov: torch.Tensor, H: torch.Tensor, res: torch.Tensor, r_diag: torch.Tensor):
    """EKF update with full-width H in square-root form (StateHelper::EKFUpdate).

    With L = chol(S), W = L⁻¹(HP), u = L⁻¹res: P' = P − WᵀW, dx = Wᵀu,
    χ² = uᵀu. The downdate is the :func:`kernels.kalman_downdate` kernel.
    cov [B, D, D], H [B, M, D], res [B, M], r_diag [B, M] (or [M]).
    Returns (dx [B, D], P' [B, D, D], χ² [B]).
    """
    Ma = cov @ H.transpose(-1, -2)                                # [B, D, M]
    S = H @ Ma + torch.diag_embed(r_diag.expand(res.shape))
    S = 0.5 * (S + S.transpose(-1, -2))
    L = cholesky_or_nan(S)
    W = torch.linalg.solve_triangular(L, Ma.transpose(-1, -2), upper=False).contiguous()
    u = torch.linalg.solve_triangular(L, res[..., None], upper=False)[..., 0].contiguous()
    new_cov, dx = kernels.kalman_downdate(cov.contiguous(), W, u)
    chi2 = (u * u).sum(-1)
    return dx, new_cov, chi2


def innovation_chi2(cov: torch.Tensor, H: torch.Tensor, res: torch.Tensor, r_diag: torch.Tensor):
    """resᵀ (H P Hᵀ + R)⁻¹ res without forming the update (gating only).

    cov [..., D, D] broadcasts against H [..., M, D]; res and r_diag
    [..., M]. A failed factorization gives NaN, which fails every gate."""
    S = H @ (cov @ H.transpose(-1, -2)) + torch.diag_embed(r_diag.expand(res.shape))
    S = 0.5 * (S + S.transpose(-1, -2))
    L = cholesky_or_nan(S)
    return (res[..., None, :] @ torch.cholesky_solve(res[..., None], L))[..., 0, 0]


def _quat_boxplus(q: torch.Tensor, dth: torch.Tensor) -> torch.Tensor:
    dq = quat_norm(torch.cat([0.5 * dth, torch.ones_like(dth[..., :1])], dim=-1))
    return quat_multiply(dq, q)


def apply_dx(state, dx: torch.Tensor):
    """Box-plus the error-state correction dx [B, D] onto the state means
    (JPL pose update q ← quat([δθ/2, 1]) ⊗ q; vectors add; FEJ untouched)."""
    lay = state.layout
    B = dx.shape[0]
    imu = torch.cat([
        _quat_boxplus(state.imu[:, 0:4], dx[:, lay.IMU_TH:lay.IMU_TH + 3]),
        state.imu[:, 4:16] + dx[:, lay.IMU_P:lay.IMU_P + 12],
    ], dim=1)
    if lay.calib_dt or lay.calib_pose or lay.calib_intr:
        raise NotImplementedError("calibration error states come with a later slice of the port")
    K, L, P = lay.max_clones, lay.max_slam, lay.max_planes
    dclone = dx[:, lay.clone_base:lay.clone_base + 6 * K].reshape(B, K, 6)
    dslam = dx[:, lay.slam_base:lay.slam_base + 3 * L].reshape(B, L, 3)
    dplane = dx[:, lay.plane_base:lay.plane_base + 3 * P].reshape(B, P, 3)
    return state.replace(
        imu=imu,
        clones_q=_quat_boxplus(state.clones_q, dclone[..., 0:3]),
        clones_p=state.clones_p + dclone[..., 3:6],
        slam_p=state.slam_p + dslam,
        plane_cp=state.plane_cp + dplane,
    )


def ekf_update(state, H: torch.Tensor, res: torch.Tensor, r_diag: torch.Tensor):
    """:func:`kalman_update` + :func:`apply_dx`. Returns (new_state, χ² [B])."""
    dx, new_cov, chi2 = kalman_update(state.cov, H, res, r_diag)
    return apply_dx(state.replace(cov=new_cov), dx), chi2


def inv3(A: torch.Tensor, eps: float = 1e-300) -> torch.Tensor:
    """Closed-form 3×3 inverse (adjugate / determinant), [..., 3, 3]; a
    determinant below ``eps`` in magnitude is replaced by ``eps``."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = -(d * i - f * g)
    A02 = d * h - e * g
    det = a * A00 + b * A01 + c * A02
    det = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack([
        torch.stack([A00, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([A01, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([A02, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def householder_qt(A: torch.Tensor, X: torch.Tensor):
    """Triangularize A [..., M, c] with c Householder reflectors and apply the
    same Qᵀ to X [..., M, R]. Returns (QᵀA, QᵀX). Zero (masked) rows stay
    zero; an all-zero column applies no reflection."""
    c = A.shape[-1]
    dtype = A.dtype
    rows = torch.arange(A.shape[-2], device=A.device)
    tiny = 1e-30 if dtype == torch.float64 else 1e-18
    for j in range(c):
        col = torch.where(rows >= j, A[..., :, j], torch.zeros_like(A[..., :, j]))
        s2 = torch.sum(col * col, dim=-1)
        big = s2 > tiny
        nrm = torch.sqrt(torch.where(big, s2, torch.ones_like(s2)))
        sign = torch.where(col[..., j] >= 0, 1.0, -1.0).to(dtype)
        v = col.clone()
        v[..., j] = v[..., j] + sign * nrm
        v2 = torch.sum(v * v, dim=-1)
        scale = torch.where(big, 2.0 / torch.where(v2 > tiny, v2, torch.ones_like(v2)),
                            torch.zeros_like(v2))
        vs = (scale[..., None] * v)[..., :, None]                    # [..., M, 1]
        A = A - vs * (v[..., None, :] @ A)
        X = X - vs * (v[..., None, :] @ X)
    return A, X


def nullspace_project(H_f: torch.Tensor, H_x: torch.Tensor, res: torch.Tensor):
    """Left-nullspace projection of H_f [..., M, c] applied to (H_x, res).

    Returns (H_x' [..., M−c, Dx], res' [..., M−c]): one orthonormal-basis
    representation of the projected system; every consumer (Gram, χ², EKF
    update) is invariant to the basis."""
    c = H_f.shape[-1]
    _, Xt = householder_qt(H_f, torch.cat([H_x, res[..., None]], dim=-1))
    return Xt[..., c:, :-1], Xt[..., c:, -1]


def measurement_compress(H: torch.Tensor, res: torch.Tensor):
    """Thin-QR measurement compression (UpdaterHelper::measurement_compress_inplace).

    H [B, M, D] -> (R [B, r, D], Qᵀres [B, r]) with r = min(M, D)."""
    q_thin, r_mat = torch.linalg.qr(H, mode="reduced")
    return r_mat, (q_thin.transpose(-1, -2) @ res[..., None])[..., 0]


def info_compress_rows(M_big: torch.Tensor) -> torch.Tensor:
    """Triangular compressed rows of stacked blocks M_big [..., R, C] through
    the information form: R [..., C, C] with RᵀR = M_bigᵀM_big, the R factor
    thin QR gives (up to row signs) when the Gram of the nonzero columns is
    SPD. The columns are first scaled to unit norm (exact, and it keeps the
    Cholesky usable on stacks that mix units); all-zero columns get a unit
    pivot and come out as zero rows. Where that factorization fails (a
    rank-deficient stack), the block takes an eps·I-jittered factor instead
    (eps = 1e-14 in f64), chosen per block by a finite check.

    The Gram and its factor are formed in f64 whatever the input's type, and
    the result is cast back. The plane stacks are rank-deficient by nature
    (the global translation and yaw of clones and plane together are not
    observed): in f32 the rounding of the Gram exceeds any jitter f32 can
    hold, so both factorizations fail and no plane would ever be
    initialized (the JAX package's f32 path fails the same way on the CPU).
    """
    dtype = M_big.dtype
    M_big = M_big.double()
    C = M_big.shape[-1]
    s = torch.sqrt(torch.sum(M_big * M_big, dim=-2))
    nz = s > 0
    sg = torch.where(nz, s, torch.ones_like(s))
    Mn = M_big / sg[..., None, :]
    G = Mn.transpose(-1, -2) @ Mn
    Ge = G + torch.diag_embed(torch.where(nz, 0.0, 1.0).to(G.dtype))
    L = cholesky_or_nan(Ge)
    Lj = cholesky_or_nan(Ge + 1e-14 * torch.eye(C, dtype=G.dtype, device=G.device))
    finite = torch.isfinite(L).all(dim=-1).all(dim=-1)[..., None, None]
    L = torch.where(finite, L, Lj)
    return (L.transpose(-1, -2) * torch.where(nz, s, torch.zeros_like(s))[..., None, :]).to(dtype)


def qr_init_split(H_L: torch.Tensor, H_R: torch.Tensor, res: torch.Tensor):
    """Rotate [H_L | H_R | res] so the top c rows isolate the new variable
    (StateHelper::initialize). H_L [..., M, c], H_R [..., M, D], res [..., M].
    Returns (H_L_init [..., c, c], H_R_init [..., c, D], res_init [..., c],
    H_R_up [..., M−c, D], res_up [..., M−c])."""
    c = H_L.shape[-1]
    A, Xt = householder_qt(H_L, torch.cat([H_R, res[..., None]], dim=-1))
    H_R2, res2 = Xt[..., :-1], Xt[..., -1]
    return A[..., :c, :c], H_R2[..., :c, :], res2[..., :c], H_R2[..., c:, :], res2[..., c:]


def initialize_invertible(state, slot_start: torch.Tensor, H_R: torch.Tensor, H_L: torch.Tensor,
                          r_diag: torch.Tensor, res: torch.Tensor):
    """Initialize a 3-dof variable in a (zeroed) slot from an invertible
    system (StateHelper::initialize_invertible). slot_start [B], H_R
    [B, 3, D], H_L [B, 3, 3], r_diag [3] or [B, 3], res [B, 3]. Returns
    (new_cov, dx_new [B, 3]): the caller writes value ⊞ dx_new into the slot."""
    Ma = state.cov @ H_R.transpose(-1, -2)                               # [B, D, 3]
    M = H_R @ Ma + torch.diag_embed(r_diag.expand(res.shape))
    H_Linv = inv3(H_L)
    P_LL = H_Linv @ M @ H_Linv.transpose(-1, -2)
    cross = -Ma @ H_Linv.transpose(-1, -2)
    cov = write_slot(state.cov, slot_start, cross, P_LL)
    return cov, (H_Linv @ res[..., None])[..., 0]
